"""Reduction of a ``torch.profiler`` trace of whole units of work to what
the per-layer metrics read: device time by kernel, the device's busy
time (the union of its operations' intervals), and the idle gaps
labelled by what the host was doing."""
from __future__ import annotations

import bisect
import dataclasses


def kernel_key(name: str) -> str:
    """A device operation's short name: the last ``::`` part before any
    template arguments or parameter list, without a return type (``void
    pc::counters_kernel<...>(...)`` is ``counters_kernel``)."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    name = name.replace("(anonymous namespace)::", "")
    key = name.split("<")[0].split("(")[0].split("::")[-1].strip()
    return key.split(" ")[-1] or name[:40]


@dataclasses.dataclass
class Summary:
    window_s: float                   # host wall of the profiled units
    units: int                        # whole units profiled
    busy_s: float                     # union of device intervals
    kernels: dict                     # short name -> [launches, seconds]
    gaps: list                        # [(label, seconds)], longest first

    def seconds(self, *names: str) -> float:
        return sum(self.kernels.get(n, [0, 0.0])[1] for n in names)

    def launches(self, name: str) -> int:
        return int(self.kernels.get(name, [0, 0.0])[0])

    def breakdown(self) -> dict:
        ops = sorted(([k, v[1]] for k, v in self.kernels.items()),
                     key=lambda kv: -kv[1])[:10]
        return {"device_ops": ops,
                "idle_gaps": [[label, s] for label, s in self.gaps[:10]]}


def _is_annotation(evt) -> bool:
    return bool(getattr(evt, "is_user_annotation", False))


def summarize(prof, window_s: float, units: int) -> Summary:
    """Reduce the profile ``prof`` of ``units`` whole units that took
    ``window_s`` seconds of host wall."""
    from torch.autograd import DeviceType

    kernels: dict[str, list] = {}
    intervals = []
    host = []       # (start_us, end_us, name): host ops, for labels
    spans = []      # the harness's spans (profiler ranges) on the host
    for evt in prof.events():
        tr = evt.time_range
        if evt.device_type == DeviceType.CUDA:
            if _is_annotation(evt):
                continue
            k = kernels.setdefault(kernel_key(evt.name), [0, 0.0])
            k[0] += 1
            k[1] += tr.elapsed_us() / 1e6
            intervals.append((tr.start, tr.end))
        elif _is_annotation(evt):
            spans.append((tr.start, tr.end, evt.name))
        else:
            host.append((tr.start, tr.end, evt.name))
    intervals.sort()
    busy_us = 0.0
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        busy_us += e - s
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gaps.append((s1 - e0, e0, s1))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    labelled = [(_label(host, starts, spans, (a + b) / 2), g / 1e6)
                for g, a, b in gaps[:10]]
    return Summary(window_s=window_s, units=units, busy_s=busy_us / 1e6,
                   kernels=kernels, gaps=labelled)


def _label(host, starts, spans, t: float) -> str:
    """What the host was doing at ``t``: the innermost harness span and
    the innermost host operation that hold it (``span > op``)."""
    inside = [sp for sp in spans if sp[0] <= t <= sp[1]]
    span = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else ""
    i = bisect.bisect_right(starts, t)
    holding = [h for h in host[max(0, i - 2000):i] if h[1] >= t]
    op = min(holding, key=lambda h: h[1] - h[0])[2] if holding else ""
    return " > ".join(x for x in (span, op) if x) or "host idle"
