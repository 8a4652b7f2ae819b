"""K1's share of its roofline over the profiled analysis calls: the
least time its launches could take (the bytes bind: each word read
once, every counter written once, at 3.35 TB/s) over their device time
(``counters_kernel`` in the profiler's trace). Nothing to read unless the
profile holds whole calls of two launches a site."""
from perfbench.harness import costs, peaks


def read(run):
    p = run.profiled
    if p is None or p.units < 1:
        return None
    batch = int(run.traffic["batch"])
    sites = len(costs.cnn_sites(run.config, batch))
    if p.launches("counters_kernel") != 2 * sites * p.units:
        return None
    t = p.seconds("counters_kernel")
    if t <= 0:
        return None
    nbytes, ops = costs.cnn_k1_call(run.config, batch)
    least = p.units * costs.bound_s(nbytes, ops, peaks.ALU_OPS_PER_S)
    return 100.0 * least / t
