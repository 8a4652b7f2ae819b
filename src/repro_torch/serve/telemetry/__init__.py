"""repro_torch.serve.telemetry -- windowed counter telemetry and online
traffic-aware design selection (the JAX package's
``repro.serve.telemetry``).

The serve accountant already attributes every streamed operand to a
request; this package watches that stream in MOTION. A
:class:`WindowedRegistry` partitions the per-request retirement records
into tumbling or sliding windows (boundaries at request retirement --
windows are exact sums of whole per-request reports, and replaying all
windows reproduces ``engine.trace_report()`` bit-exactly); an
:class:`OnlineSelector` re-runs the paper's per-site greedy design
choice on every closed window with hysteresis + dwell damping, emitting
a :class:`SelectionTimeline` of per-site design flips and
fixed-vs-online-vs-oracle savings tracks. Scenario drivers
(:mod:`.scenarios`) script the traffic shifts that make the optimal
design flip; ``python -m repro_torch.serve.telemetry`` replays dumped
records offline for window/hysteresis what-ifs. Records, timelines and
reports keep the JAX package's schema strings, so each package reads the
other's dumps.

Wiring: set ``ServeConfig(power_monitor=True, telemetry=
TelemetryConfig(...))`` -- the engine (slot or paged) hangs a
:class:`ServeTelemetry` off the accountant's retirement hook and
exposes ``engine.telemetry_report()``. With ``TelemetryConfig(actuate=
True)`` the engine commits the selector's staged flips into its
accountant at each step boundary (:meth:`ServeTelemetry.actuate_pending`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import monitor

from .registry import (TelemetryConfig, Window,       # noqa: F401
                       WindowedRegistry, load_records)
from .selector import (FlipEvent, OnlineSelector,     # noqa: F401
                       SelectionTimeline, SwapEvent, WindowSelection)

__all__ = [
    "FlipEvent", "OnlineSelector", "SelectionTimeline", "ServeTelemetry",
    "SwapEvent", "TelemetryConfig", "Window", "WindowSelection",
    "WindowedRegistry", "load_records",
]


class ServeTelemetry:
    """Registry + selector, wired: feed retirements, read the timeline.

    ``on_retire`` is the accountant hook; the registry fires the
    selector on every closed window. :meth:`finalize` (idempotent)
    closes partial windows and fills the oracle-static track;
    :meth:`report` is the JSON-ready roll-up ``engine.telemetry_report()``
    returns.
    """

    def __init__(self, tcfg: TelemetryConfig,
                 mcfg: monitor.MonitorConfig = monitor.DEFAULT_MONITOR):
        self.tcfg = tcfg
        self.mcfg = mcfg
        self.registry = WindowedRegistry(tcfg, mcfg)
        self.selector = OnlineSelector(tcfg, mcfg)
        self.registry.on_window.append(self.selector.observe)
        self._finalized = False

    def on_retire(self, rec) -> None:
        self.registry.observe(rec)

    def actuate_pending(self, accountant) -> "SwapEvent | None":
        """Drain the selector's staged flips into the accountant -- the
        engine calls this between steps, on the host, never inside a
        decode step. Returns the logged :class:`SwapEvent`, or None when
        nothing was staged or the commit changed nothing (a flip back to
        the design already active)."""
        mapping, deltas, win = self.selector.take_pending()
        if not mapping:
            return None
        changed = {s: d for s, d in mapping.items()
                   if accountant.design_for(s) != d}
        if not changed:
            return None
        epoch = accountant.apply_swaps(changed)
        ev = SwapEvent(
            epoch=epoch, window=win, sites=changed,
            deltas={s: deltas[s] for s in changed if s in deltas},
            delta_fj=sum(deltas[s] for s in changed if s in deltas))
        self.timeline.swaps.append(ev)
        return ev

    @property
    def timeline(self) -> SelectionTimeline:
        return self.selector.timeline

    def finalize(self) -> SelectionTimeline:
        """Close out the run: flush partial windows through the selector,
        then fill the oracle-static savings track. Idempotent."""
        if not self._finalized:
            self._finalized = True
            self.registry.flush()
            self.selector.finalize(self.registry)
        return self.selector.timeline

    def report(self) -> dict:
        timeline = self.finalize()
        return {
            "schema": "repro.serve.telemetry/report/v1",
            "config": dataclasses.asdict(self.tcfg),
            "designs": list(self.mcfg.design_names),
            "n_retired": self.registry.n_retired,
            "windows": [w.summary()
                        for w in self.registry.closed_windows()],
            "timeline": timeline.to_json_dict(),
        }
