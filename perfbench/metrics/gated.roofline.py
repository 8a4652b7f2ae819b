"""The gated decode kernels' share of their roofline over the profiled
steps: K2's launches (every decode product: the layers' projections and
MLPs and the head, at the cell's decode rows) and K3's (the accountant's
two sampled sites a step), the least time of each -- K2's bytes at 3.35
TB/s against its bfloat16 FLOPs at 989 TFLOP/s, K3's bytes against its
counter operations at 67 TOP/s -- summed, over the device time of
``stream_kernel`` and ``walk_kernel``. K2 and K3 share ``stream_kernel``,
so they are one layer. K3's zero fill is left out of the time. Nothing
to read unless the profile holds whole steps, each with every launch."""
from perfbench.harness import costs, peaks


def read(run):
    p = run.profiled
    if p is None or p.units < 1:
        return None
    cfg = run.config
    rows = int(run.cell["engine"].get("max_slots",
                                      run.cell["engine"].get("paging", {})
                                      .get("max_rows", 0)))
    n2 = costs.k2_launches(cfg)
    n3 = len(costs.accountant_sites(cfg))
    steps = p.launches("walk_kernel") // n3
    if (steps < 1 or p.launches("walk_kernel") != n3 * steps
            or p.launches("stream_kernel") != (n2 + n3) * steps):
        return None
    t = p.seconds("stream_kernel", "walk_kernel")
    if t <= 0:
        return None
    b2, f2 = costs.k2_step(cfg, rows)
    b3, o3 = costs.k3_step(cfg, rows)
    least = steps * (costs.bound_s(b2, f2, peaks.BF16_FLOPS)
                     + costs.bound_s(b3, o3, peaks.ALU_OPS_PER_S))
    return 100.0 * least / t
