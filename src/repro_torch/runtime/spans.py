"""Named host spans at the port's layer boundaries.

``with spans.span("serve.decode"): ...`` marks one call into a layer: the
serving engine's step, admission, decode and retirement, the model's
blocks, the CNN capture and its per-site counting and pricing. Span names
are layer names (``serve.*``, ``model.*``, ``cnn.*``, ``sa.*``,
``design.*``), not power sites: :mod:`repro_torch.trace` is the power
tracer, and this module has nothing to do with it.

A span costs nothing unless someone looks:

* **off** (the default) with no ``torch.profiler`` running, ``span()``
  returns one shared no-op context object: it allocates nothing, calls
  no torch function and never synchronizes the card;
* **profiled**: while a ``torch.profiler`` runs, each span is also a
  ``torch.profiler.record_function`` range, so the profile holds the
  program's spans on its own clock beside the kernels and the launch
  calls that each span made (the device time and the idle time of a
  profile can be put down to the innermost span holding them);
* **on** (:func:`enable` ... :func:`take`): each span is also kept in
  memory as a :class:`Record` (name, ``perf_counter_ns`` start and end,
  the index of the span open around it) and handed over by
  :func:`take`; nothing is written anywhere.
  :func:`summary` gives count, total and self time by name.

Spans nest on the one thread that runs the engine or the analysis.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler


class Record(NamedTuple):
    """One closed span: ``parent`` is the index (in the same list) of the
    span open around it, -1 at the top."""
    name: str
    start_ns: int
    end_ns: int
    parent: int


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: the one object ``span()`` returns while spans are off and no profiler
#: runs
NOOP = _Noop()

_records: list | None = None      # None: off
_stack: list[int] = []            # indices of the open spans


def span(name: str):
    """A context manager marking one call into a layer (module doc)."""
    if _records is None:
        if not _profiler._is_profiler_enabled:
            return NOOP
        return torch.profiler.record_function(name)
    return _Span(name)


class _Span:
    __slots__ = ("name", "index", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.index = len(_records)
        _records.append(None)            # filled in when the span closes
        _stack.append(self.index)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack.pop()
        _records[self.index] = Record(
            self.name, self.start, end, _stack[-1] if _stack else -1)
        return False


def enable() -> None:
    """Keep every span from now on, until :func:`disable`."""
    global _records
    if _records is None:
        _records = []


def disable() -> None:
    """Stop keeping spans; what was not taken is dropped."""
    global _records
    if _stack:
        raise RuntimeError(f"{len(_stack)} span(s) still open")
    _records = None


def take() -> list[Record]:
    """The records kept since :func:`enable` or the last ``take()``, in
    the order the spans opened; the store starts empty again. Call it
    between top-level spans: parent indices point into the list it
    returns."""
    global _records
    if _records is None:
        return []
    if _stack:
        raise RuntimeError(f"take() inside {len(_stack)} open span(s)")
    out, _records = _records, []
    return out


def summary(records: list[Record]) -> dict[str, dict]:
    """Count, total and self milliseconds by span name, largest total
    first. Self time is a span's duration less the parts its children
    cover."""
    child = [0] * len(records)
    for r in records:
        if r.parent >= 0:
            child[r.parent] += r.end_ns - r.start_ns
    out: dict[str, dict] = {}
    for r, c in zip(records, child):
        d = out.setdefault(r.name, {"count": 0, "total_ms": 0.0,
                                    "self_ms": 0.0})
        dur = r.end_ns - r.start_ns
        d["count"] += 1
        d["total_ms"] += dur / 1e6
        d["self_ms"] += (dur - c) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_ms"]))


def format_summary(summ: dict[str, dict]) -> str:
    """``summary()`` as a table: name, count, total and self ms."""
    w = max([4] + [len(n) for n in summ])
    lines = [f"{'span':<{w}s} {'count':>7s} {'total_ms':>11s} "
             f"{'self_ms':>11s}"]
    for n, d in summ.items():
        lines.append(f"{n:<{w}s} {d['count']:7d} {d['total_ms']:11.3f} "
                     f"{d['self_ms']:11.3f}")
    return "\n".join(lines)
