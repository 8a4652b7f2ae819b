"""Device time and device idle time of a ``torch.profiler`` trace, each put
down to the program span that caused it.

The port's spans (:mod:`repro_torch.runtime.spans`) are
``record_function`` ranges in a profile, on the profile's own clock. A
kernel is charged to the spans that hold its launch call on the host: the
CUDA runtime call with the kernel's correlation id, else the host
operation the kernel is linked to. An idle interval of the card (between
two of its merged busy intervals, as :func:`.profile.summarize` finds
them) is charged to the spans that hold it, split where a span begins or
ends. Each charge goes to the innermost span (``by_span``) and to every
span around it (``in_span``); what no span holds goes under ``"(none)"``.

Below :func:`attribute`, the per-layer quantities the program's spans and
counters give, each over what a traced run holds: the attribution of its
profiled units, the program's span records, the engine's ``stats``
deltas and its requests. Each returns None where the run gave it nothing
to read, as a reader does.
"""
from __future__ import annotations

import bisect

from . import stats
from .profile import kernel_key

NONE = "(none)"

#: the program's span names begin so; ``cnn.count_price`` is the
#: harness's own span around the pricing (``cnn.capture`` is both the
#: harness's and the program's name for the capture: the harness's span
#: holds the program's and nothing else)
PREFIXES = ("serve.", "model.", "cnn.", "sa.", "design.")
HARNESS = ("cnn.count_price",)


def is_program(name: str) -> bool:
    """Whether an annotation of the profile is one of the program's
    spans."""
    return name.startswith(PREFIXES) and name not in HARNESS


def _timeline(spans):
    """Boundaries ``b`` and the stacks of span names that hold each
    segment ``[b[i], b[i + 1])``, outermost first."""
    points = []
    for i, (s, e, _) in enumerate(spans):
        if e > s:
            points.append((s, 1, -(e - s), i))
            points.append((e, 0, 0, i))
    points.sort()
    bounds, stacks, active = [], [], []
    for j, (t, kind, _, i) in enumerate(points):
        if kind:
            active.append(i)
        else:
            active.remove(i)
        if j + 1 < len(points) and points[j + 1][0] == t:
            continue
        stack = tuple(spans[k][2] for k in active)
        if stacks and stacks[-1] == stack:
            continue
        bounds.append(t)
        stacks.append(stack)
    return bounds, stacks


def _stack_at(bounds, stacks, t) -> tuple:
    i = bisect.bisect_right(bounds, t) - 1
    return stacks[i] if i >= 0 else ()


def _charge(out: dict, stack: tuple, seconds: float) -> None:
    inner = stack[-1] if stack else NONE
    out["by_span"][inner] = out["by_span"].get(inner, 0.0) + seconds
    for name in set(stack) or (NONE,):
        out["in_span"][name] = out["in_span"].get(name, 0.0) + seconds


def attribute(events, is_program=lambda name: True, top: int = 6) -> dict:
    """Charge the device time and the idle time of a profile's ``events``
    (``prof.events()``) to the annotations ``is_program`` accepts.

    Returns ``{"device": {"total_s", "by_span", "in_span",
    "kernels_by_span"}, "idle": {"total_s", "by_span", "in_span"},
    "linked": {"launch", "op", "none"}}``: seconds; ``kernels_by_span``
    the ``top`` kernels (short names) of each innermost span; ``linked``
    how many kernels were placed by their launch call, by their host
    operation, or not at all.
    """
    from torch.autograd import DeviceType

    spans, kernels = [], []
    launch_at, op_at = {}, {}
    for evt in events:
        tr = evt.time_range
        annotation = bool(getattr(evt, "is_user_annotation", False))
        if evt.device_type == DeviceType.CUDA:
            if not annotation:
                kernels.append((tr.start, tr.end, evt))
        elif annotation:
            if is_program(evt.name):
                spans.append((tr.start, tr.end, evt.name))
        elif evt.name.startswith("cu"):      # cudaLaunchKernel, cuLaunchKernel
            launch_at[evt.id] = tr.start
        else:
            op_at.setdefault(evt.id, tr.start)
    bounds, stacks = _timeline(spans)
    device = {"total_s": 0.0, "by_span": {}, "in_span": {}}
    per_kernel: dict[str, dict[str, float]] = {}
    linked = {"launch": 0, "op": 0, "none": 0}
    intervals = []
    for s, e, evt in kernels:
        seconds = (e - s) / 1e6
        intervals.append((s, e))
        if evt.id in launch_at:
            t, how = launch_at[evt.id], "launch"
        elif getattr(evt, "linked_correlation_id", 0) in op_at:
            t, how = op_at[evt.linked_correlation_id], "op"
        else:
            t, how = None, "none"
        linked[how] += 1
        stack = () if t is None else _stack_at(bounds, stacks, t)
        device["total_s"] += seconds
        _charge(device, stack, seconds)
        k = per_kernel.setdefault(stack[-1] if stack else NONE, {})
        key = kernel_key(evt.name)
        k[key] = k.get(key, 0.0) + seconds
    device["kernels_by_span"] = {
        span: dict(sorted(ks.items(), key=lambda kv: -kv[1])[:top])
        for span, ks in per_kernel.items()}
    return {"device": device, "idle": _idle(intervals, bounds, stacks),
            "linked": linked}


def _idle(intervals, bounds, stacks) -> dict:
    """The gaps between merged device intervals, charged segment by
    segment of the span timeline."""
    intervals.sort()
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    out = {"total_s": 0.0, "by_span": {}, "in_span": {}}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        out["total_s"] += (b - a) / 1e6
        i = bisect.bisect_right(bounds, a) - 1
        t = a
        while t < b:
            end = min(bounds[i + 1] if i + 1 < len(bounds) else b, b)
            _charge(out, stacks[i] if i >= 0 else (), (end - t) / 1e6)
            t = end
            i += 1
    return out


# ------------------------------------------------- per-layer quantities
def named_share(att: dict) -> float | None:
    """Percent of the profiled device time charged to a program span."""
    dev = att["device"]
    if not dev["total_s"]:
        return None
    return 100.0 * (dev["total_s"] - dev["by_span"].get(NONE, 0.0)) \
        / dev["total_s"]


def stream_prep_device_ms(att: dict, units: int) -> float | None:
    """``cnn.stream_prep_device_ms``: device ms of the kernels launched
    inside ``sa.edge_streams``, a profiled call."""
    s = att["device"]["in_span"].get("sa.edge_streams")
    return None if s is None or not units else 1e3 * s / units


def dispatch_idle_ms(att: dict, units: int) -> float | None:
    """``idle.serve.dispatch_ms``: the card's idle ms inside a
    ``model.*`` span (the host dispatching the model's layers), a
    profiled step."""
    idle = [v for k, v in att["idle"]["by_span"].items()
            if k.startswith("model.")]
    return 1e3 * sum(idle) / units if idle and units else None


def prefill_device_ms_per_1k_rows(att: dict,
                                  profiled: dict) -> float | None:
    """``serve.prefill_device_ms_per_1k_rows``: device ms of the kernels
    launched inside ``serve.prefill``, per 1024 of the engine's
    ``prefill_rows`` over the same profiled steps (``profiled``: the
    engine's ``stats`` deltas over them)."""
    s = att["device"]["in_span"].get("serve.prefill")
    rows = profiled.get("prefill_rows", 0)
    return None if s is None or not rows else 1e3 * s * 1024 / rows


def queue_wait_p95_ms(requests) -> float | None:
    """``serve.queue_wait_p95_ms``: p95 of the engine's ``t_admit -
    t_submit`` over ``requests`` (those sent in the window)."""
    return stats.percentile([(q.t_admit - q.t_submit) / 1e6
                             for q in requests if q.t_admit], 95)


def prefix_hit_share(window: dict) -> float | None:
    """``serve.prefix_hit_share``: percent of the prompt rows admitted in
    the window (``window``: the engine's ``stats`` deltas over it) that
    came from the prefix cache."""
    hit = window.get("prefix_hit_rows", 0)
    rows = window.get("prefill_rows", 0) + hit
    return 100.0 * hit / rows if rows else None


def price_host_ms(records, units_ns) -> float | None:
    """``cnn.price_host_ms``: host ms inside ``design.price`` spans
    (``records``: the program's span records) a call, median over the
    calls whose host intervals ``units_ns`` holds."""
    prices = [sum(r.end_ns - r.start_ns for r in records
                  if r.name == "design.price" and a <= r.start_ns < b)
              / 1e6 for a, b in units_ns]
    return stats.median(prices) if prices and any(prices) else None
