"""The grouped gated expert kernel's (K8's) share of the card's busy time
over the profiled engine steps: ``expert_kernel``'s device time over the
union of the trace's device intervals. Nothing to read unless the profile
holds whole steps: ``expert_kernel``'s launches two a MoE layer for each
decode and each admission the profiled steps made."""
from perfbench.harness import core


def read(run):
    p = run.profiled
    if p is None or p.units < 1 or p.busy_s <= 0:
        return None
    ref = core.reference(run.config)
    if not hasattr(ref, "expert_launches"):
        return None
    admitted = run.notes.get("admitted_rows", [])
    per = ref.expert_launches(run.config)
    if p.launches("expert_kernel") != per * (p.units + len(admitted)):
        return None
    t = p.seconds("expert_kernel")
    if t <= 0:
        return None
    return 100.0 * t / p.busy_s
