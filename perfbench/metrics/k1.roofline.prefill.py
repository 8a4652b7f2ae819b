"""K1's share of its roofline over the admissions in the profiled steps:
the prompt accounting's launches (two monitored sites, a West and a North
stream each), the least time by their bytes, over the device time of
``counters_kernel``. Nothing to read unless every admission's four
launches are in the profile."""
from perfbench.harness import costs, peaks


def read(run):
    p = run.profiled
    rows = run.notes.get("admitted_rows", [])
    if p is None or not rows:
        return None
    n = 2 * len(costs.accountant_sites(run.config))
    if p.launches("counters_kernel") != n * len(rows):
        return None
    t = p.seconds("counters_kernel")
    if t <= 0:
        return None
    least = sum(costs.bound_s(*costs.k1_admission(run.config, m),
                              peaks.ALU_OPS_PER_S) for m in rows)
    return 100.0 * least / t
