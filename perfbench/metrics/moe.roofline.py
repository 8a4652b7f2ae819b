"""The grouped gated expert kernel's (K8's) share of its roofline over the
profiled engine steps. Each step's decode (the cell's ``max_slots`` rows)
and each admission's prefill (its prompt's power-of-two bucket of tokens)
run two K8 launches a MoE layer; the least time of each forward -- every
expert's three bfloat16 weights read once a layer (a 128-row decode step
routes 768 pairs and leaves an expert unused with probability 3e-6; an
admission's bucket of 32 tokens or more, 5% or less, counted as read), the
routed rows in and out of both launches, at 3.35 TB/s, against 2 x pairs
x 3 x D x F FLOPs at 989 TFLOP/s -- summed, over the device time of
``expert_kernel``. Nothing to read unless the profile holds whole steps:
``expert_kernel``'s launches two a MoE layer for each decode and each
admission the profiled steps made."""
from perfbench.harness import core, costs, peaks


def _bucket(rows: int, cache_len: int) -> int:
    return min(1 << max(rows - 1, 0).bit_length(), cache_len - 1)


def read(run):
    p = run.profiled
    if p is None or p.units < 1:
        return None
    cfg = run.config
    ref = core.reference(cfg)
    if not hasattr(ref, "expert_step"):
        return None
    eng = run.cell["engine"]
    admitted = run.notes.get("admitted_rows", [])
    per = ref.expert_launches(cfg)
    if p.launches("expert_kernel") != per * (p.units + len(admitted)):
        return None
    t = p.seconds("expert_kernel")
    if t <= 0:
        return None
    forwards = [int(eng["max_slots"])] * p.units + [
        _bucket(int(r), int(eng["cache_len"])) for r in admitted]
    least = 0.0
    for tokens in forwards:
        nbytes, flops = ref.expert_step(cfg, tokens)
        least += costs.bound_s(nbytes, flops, peaks.BF16_FLOPS)
    return 100.0 * least / t
