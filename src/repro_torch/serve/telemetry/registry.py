"""Windowed counter registry: the retirement stream, partitioned.

The accountant emits one :class:`repro_torch.serve.power.RetirementRecord` per
finished request -- the exact per-site counters it just booked into the
serve-wide capture. This module partitions that stream into tumbling or
sliding windows whose boundaries sit AT request retirement, which buys
two exactness properties no step- or wall-clock-aligned windowing has:

* **each window is an exact sum of whole retired-request reports** -- a
  request's energy is never split across windows, so per-window savings
  are honest energies-before-ratios aggregates over the traffic that
  retired inside the window;
* **windows lose nothing**: replaying every window's records (deduped by
  retirement sequence number for overlapping sliding windows) in
  retirement order through ``TraceCapture.record_counters`` performs the
  identical float additions in the identical order as the engine's own
  capture, so :meth:`WindowedRegistry.merged_report` reproduces
  ``engine.trace_report()`` BIT-exactly -- at any ``sample_every``, for
  the slot and the paged engine alike (the invariant per-request
  reports keep, lifted to windows).

Window geometry is counted in retirements: ``window`` requests per
window, a new window opening every ``stride`` retirements.
``stride == window`` is tumbling (each retirement in exactly one
window); ``stride < window`` is sliding (overlap ``window - stride``).
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core import monitor
from repro_torch.serve.power import RetirementRecord
from repro_torch.trace.capture import CaptureConfig, TraceCapture
from repro_torch.trace.report import TraceReport, build_report


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Windowing and online-selection knobs.

    ``window``/``stride`` count retired requests. ``hysteresis`` is the
    relative per-site energy margin a challenger design must beat the
    incumbent by IN THE CURRENT WINDOW before the selector flips;
    ``min_dwell`` is how many consecutive windows the incumbent must
    have held before it may be dethroned at all. ``candidates`` names
    the designs the selector chooses among (default: every design in
    the monitor's list, reference included -- "encode nothing" is a
    legitimate choice).

    ``actuate=True`` closes the loop: committed flips are APPLIED to the
    engine's accountant at the next step boundary, so subsequently
    recorded traffic prices under the flipped choice (swap epochs,
    :meth:`repro_torch.serve.power.PowerAccountant.apply_swaps`).
    """
    window: int = 8
    stride: int | None = None        # None -> window (tumbling)
    hysteresis: float = 0.0
    min_dwell: int = 1
    candidates: tuple[str, ...] = ()
    actuate: bool = False

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1: {self.window}")
        stride = self.window if self.stride is None else self.stride
        if not 1 <= stride <= self.window:
            raise ValueError(
                f"stride must be in [1, window={self.window}]: {stride} "
                f"(stride > window would drop retirements from every "
                f"window, breaking the lossless-partition invariant)")
        if self.min_dwell < 1:
            raise ValueError(f"min_dwell must be >= 1: {self.min_dwell}")
        if self.hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0: {self.hysteresis}")

    @property
    def eff_stride(self) -> int:
        return self.window if self.stride is None else self.stride


class Window:
    """One window of the retirement stream: the records that retired in
    ``[start_seq, start_seq + cfg.window)``, kept in retirement order."""

    def __init__(self, index: int, start_seq: int, length: int):
        self.index = index
        self.start_seq = start_seq          # first retirement seq covered
        self.length = length                # retirements when full
        self.records: list[RetirementRecord] = []
        self.seqs: list[int] = []
        self.closed = False
        self.partial = False                # closed by flush(), not filled

    # ------------------------------------------------------------- filling
    def observe(self, seq: int, rec: RetirementRecord) -> None:
        self.records.append(rec)
        self.seqs.append(seq)

    @property
    def end_seq(self) -> int:
        """One past the last retirement seq this window accepts."""
        return self.start_seq + self.length

    @property
    def n_requests(self) -> int:
        return len(self.records)

    @property
    def uids(self) -> tuple[int, ...]:
        return tuple(r.uid for r in self.records)

    @property
    def new_tokens(self) -> int:
        return sum(r.new_tokens for r in self.records)

    # --------------------------------------------------------------- views
    def capture(self, mcfg: monitor.MonitorConfig) -> TraceCapture:
        """Fold this window's records (in retirement order) into a fresh
        capture -- the exact sum of its retired-request reports."""
        cap = TraceCapture(CaptureConfig(monitor=mcfg))
        for rec in self.records:
            for sr in rec.sites:
                cap.record_counters(sr.site, sr.kind, sr.shape, sr.counters)
        return cap

    def report(self, mcfg: monitor.MonitorConfig,
               model: str = "window") -> TraceReport:
        """Paper-style per-window TraceReport (same machinery as
        ``engine.trace_report()``, scoped to this window's traffic)."""
        return build_report(self.capture(mcfg),
                            model=f"{model}[{self.index}]")

    def site_counters(self) -> dict[str, dict[str, float]]:
        """Per-site flat counter sums over the window -- the counter
        delta :func:`repro_torch.design.select.select_counters` re-selects
        over without a full report build."""
        out: dict[str, dict[str, float]] = {}
        for rec in self.records:
            for sr in rec.sites:
                acc = out.setdefault(sr.site, {})
                for k, v in sr.counters.items():
                    if k == "zero_fraction":
                        continue
                    acc[k] = acc.get(k, 0.0) + float(v)
        return out

    def summary(self) -> dict:
        return {"index": self.index, "start_seq": self.start_seq,
                "n_requests": self.n_requests, "uids": list(self.uids),
                "new_tokens": self.new_tokens, "partial": self.partial}


class WindowedRegistry:
    """Partition the retirement stream into (possibly overlapping)
    windows; fire ``on_window`` hooks as each window closes."""

    def __init__(self, tcfg: TelemetryConfig,
                 mcfg: monitor.MonitorConfig = monitor.DEFAULT_MONITOR):
        self.tcfg = tcfg
        self.mcfg = mcfg
        self.windows: list[Window] = []     # every window, in start order
        self.records: list[RetirementRecord] = []   # full stream, in order
        self.on_window: list = []           # hooks fired per CLOSED window
        self._flushed = False

    @property
    def n_retired(self) -> int:
        return len(self.records)

    # ----------------------------------------------------------- observing
    def observe(self, rec: RetirementRecord) -> list[Window]:
        """Feed one retirement; returns the windows it closed (in index
        order), after their hooks ran."""
        if self._flushed:
            raise RuntimeError(
                "registry already flushed: partial windows were closed, "
                "further retirements would misalign the partition")
        seq = len(self.records)
        self.records.append(rec)
        stride, length = self.tcfg.eff_stride, self.tcfg.window
        # open every window whose span starts at or before this seq
        next_start = self.windows[-1].start_seq + stride \
            if self.windows else 0
        while next_start <= seq:
            self.windows.append(Window(len(self.windows), next_start,
                                       length))
            next_start += stride
        closed = []
        for w in self.windows:
            if w.closed or not (w.start_seq <= seq < w.end_seq):
                continue
            w.observe(seq, rec)
            if seq == w.end_seq - 1:
                w.closed = True
                closed.append(w)
        for w in closed:
            for hook in self.on_window:
                hook(w)
        return closed

    def flush(self) -> list[Window]:
        """Close still-open windows as partial (end of run); fires their
        hooks. Idempotent (a second flush is a no-op returning ``[]``);
        the registry accepts no retirements afterwards.

        Sliding geometries (``stride < window``) can leave SEVERAL open
        tail windows whose record sets nest: with window=4/stride=2 and
        5 retirements, both [2,3,4] and [4] are open. Closing every one
        would hand the selector seq 4 twice with no new information --
        the tail retirements double-count into two partial windows. Only
        open windows that cover at least one retirement no already-closed
        window covers are closed; pure-subset tails are dropped."""
        if self._flushed:
            return []
        self._flushed = True
        covered = {s for w in self.windows if w.closed for s in w.seqs}
        closed, survivors = [], []
        for w in self.windows:
            if w.closed:
                survivors.append(w)
                continue
            if any(s not in covered for s in w.seqs):
                w.closed = w.partial = True
                covered.update(w.seqs)
                survivors.append(w)
                closed.append(w)
            # else: drop -- every record already lives in a closed window
        self.windows = survivors
        for w in closed:
            for hook in self.on_window:
                hook(w)
        return closed

    # --------------------------------------------------------------- views
    def merged_capture(self) -> TraceCapture:
        """Re-assemble the FULL retirement stream from the windows (dedup
        by retirement seq -- sliding windows overlap) and fold it in
        retirement order: the identical additions, in the identical
        order, as the engine's own capture, hence bit-exact with
        ``engine.trace_report()``."""
        by_seq: dict[int, RetirementRecord] = {}
        for w in self.windows:
            for seq, rec in zip(w.seqs, w.records):
                by_seq[seq] = rec
        cap = TraceCapture(CaptureConfig(monitor=self.mcfg))
        for seq in sorted(by_seq):
            for sr in by_seq[seq].sites:
                cap.record_counters(sr.site, sr.kind, sr.shape, sr.counters)
        return cap

    def merged_report(self, model: str = "windows") -> TraceReport:
        return build_report(self.merged_capture(), model=model)

    def closed_windows(self) -> list[Window]:
        return [w for w in self.windows if w.closed and w.records]

    # ------------------------------------------------------- serialization
    def dump_records(self, path: str) -> None:
        """Write the raw retirement stream as JSON. Python floats
        round-trip exactly through JSON, so a replay
        (:mod:`repro_torch.serve.telemetry.__main__`) re-windows the identical
        counter values -- offline what-if sweeps over window / stride /
        hysteresis need no re-serve. The schema string is the JAX
        package's: either package reads the other's dumps."""
        payload = {
            "schema": "repro.serve.telemetry/records/v2",
            "designs": list(self.mcfg.design_names),
            "reference": self.mcfg.reference_design,
            "primary": self.mcfg.primary_design,
            "records": [r.to_json_dict() for r in self.records],
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)


def load_records(path: str) -> tuple[dict, list[RetirementRecord]]:
    """Load a :meth:`WindowedRegistry.dump_records` file; returns
    ``(metadata, records)`` with metadata holding the design names the
    counters were priced for."""
    with open(path) as f:
        payload = json.load(f)
    # v2 added per-record swap epochs; v1 dumps load with empty epochs
    # (every record then prices under the fixed primary on replay)
    if payload.get("schema") not in ("repro.serve.telemetry/records/v1",
                                     "repro.serve.telemetry/records/v2"):
        raise ValueError(
            f"{path}: not a telemetry records file "
            f"(schema={payload.get('schema')!r})")
    records = [RetirementRecord.from_json_dict(r)
               for r in payload["records"]]
    meta = {k: payload[k] for k in ("designs", "reference", "primary")}
    return meta, records
