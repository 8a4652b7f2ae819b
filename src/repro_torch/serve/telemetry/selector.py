"""Online traffic-aware design selection over the windowed registry.

The paper chooses WHAT to encode offline, from application statistics
gathered once. The serve engine streams exactly those statistics live,
so this module goes one step further: re-run the per-site greedy choice
(:func:`repro_torch.design.select.select_counters`) on every closed telemetry
window and track when the optimal per-site design FLIPS as traffic
shifts -- "what should the hardware have been for this hour's traffic",
a scenario class the offline methodology cannot see.

Stability is a first-class concern: real selection margins are fractions
of a percent (resnet50's bic-west vs mant-exp split), so a raw per-window
argmin would chatter. Two knobs damp it, both window-local and cheap:

* **hysteresis** -- a challenger must beat the incumbent's energy in the
  current window by a relative margin ``> hysteresis`` to take the site;
* **min_dwell** -- the incumbent must have held for at least
  ``min_dwell`` consecutive windows before any challenger is considered.

The output is a :class:`SelectionTimeline`: per-window choices, flip
events with their margins, dwell runs, and three savings tracks
(energies-before-ratios, per window): the FIXED primary design, the
ONLINE hysteresis-damped choice, and -- once :meth:`finalize` has seen
the whole run -- the ORACLE-STATIC per-site choice (the best single
assignment in hindsight, i.e. what the paper's offline method would pick
given the full run's statistics). online >= fixed checks that adaptivity
pays; oracle - online is the price of causality.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import monitor
from repro_torch.design.select import select_counters, swap_deltas
from repro_torch.serve.power import actuated_stream_energy

from .registry import TelemetryConfig, Window


@dataclasses.dataclass(frozen=True)
class FlipEvent:
    """One per-site change of the online choice, at a window boundary."""
    window: int                  # window index where the flip happened
    site: str
    old: str
    new: str
    margin: float                # relative energy win of new vs old in
                                 # that window (drove the flip)

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """One ACTUATED design swap: the commit of a window's staged flips
    into the engine's accountant, at the next step boundary."""
    epoch: int                   # accountant swap epoch after the commit
    window: int                  # last window whose flips were staged
    sites: dict                  # site -> newly active design
    deltas: dict                 # site -> fJ delta (new - old) priced on
                                 # the window that drove the flip
    delta_fj: float              # sum of deltas (negative = cheaper)

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class WindowSelection:
    """The selector's outcome for one closed window."""
    window: int
    n_requests: int
    new_tokens: int
    partial: bool
    choices: dict[str, str]      # site -> online (hysteresis-damped) pick
    raw_choices: dict[str, str]  # site -> this window's raw greedy winner
    flips: list[FlipEvent]
    energy: dict[str, float]     # per-design window totals (fJ), summed
                                 # over sites, plus "online"/"actuated"
    saving_fixed: float          # fixed primary vs reference, this window
    saving_online: float         # online choices vs reference
    saving_oracle: float = float("nan")   # filled by finalize()
    saving_actuated: float = float("nan")  # epoch-priced (as-recorded)

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["flips"] = [f.to_json_dict() for f in self.flips]
        return d


@dataclasses.dataclass
class SelectionTimeline:
    """Flip timeline of a whole run: one entry per closed window."""
    reference: str
    primary: str
    candidates: tuple[str, ...]
    windows: list[WindowSelection] = dataclasses.field(default_factory=list)
    oracle_choices: dict[str, str] = dataclasses.field(default_factory=dict)
    swaps: list[SwapEvent] = dataclasses.field(default_factory=list)

    @property
    def flip_events(self) -> list[FlipEvent]:
        return [f for w in self.windows for f in w.flips]

    @property
    def n_flips(self) -> int:
        return len(self.flip_events)

    @property
    def n_swaps(self) -> int:
        return len(self.swaps)

    def dwell_times(self) -> dict[str, list[tuple[str, int]]]:
        """Per site: the run-length encoding of its choice across
        windows -- ``[(design, n_consecutive_windows), ...]``."""
        out: dict[str, list[tuple[str, int]]] = {}
        for w in self.windows:
            for site, choice in w.choices.items():
                runs = out.setdefault(site, [])
                if runs and runs[-1][0] == choice:
                    runs[-1] = (choice, runs[-1][1] + 1)
                else:
                    runs.append((choice, 1))
        return out

    def _mean_saving(self, key: str) -> float:
        """Run-level saving, energies-before-ratios across windows."""
        ref = sum(w.energy[self.reference] for w in self.windows)
        num = sum(w.energy[key] for w in self.windows)
        return 1.0 - num / max(ref, 1e-30)

    def summary(self) -> dict:
        out = {
            "n_windows": len(self.windows),
            "n_requests": sum(w.n_requests for w in self.windows),
            "n_flips": self.n_flips,
            "n_swaps": self.n_swaps,
            "sites": sorted({s for w in self.windows for s in w.choices}),
            "reference": self.reference,
            "primary": self.primary,
            "candidates": list(self.candidates),
        }
        if self.windows:
            out["saving_fixed"] = self._mean_saving(self.primary)
            out["saving_online"] = self._mean_saving("online")
            out["saving_actuated"] = self._mean_saving("actuated")
            if self.oracle_choices:
                out["saving_oracle"] = self._mean_saving("oracle")
                out["oracle_choices"] = dict(self.oracle_choices)
        return out

    def to_json_dict(self) -> dict:
        return {
            "schema": "repro.serve.telemetry/timeline/v2",
            "summary": self.summary(),
            "dwell": {site: [list(run) for run in runs]
                      for site, runs in self.dwell_times().items()},
            "flips": [f.to_json_dict() for f in self.flip_events],
            "swaps": [s.to_json_dict() for s in self.swaps],
            "windows": [w.to_json_dict() for w in self.windows],
        }

    def to_json(self, path: str) -> None:
        from repro_torch.trace.report import write_json
        write_json(path, self.to_json_dict())

    def to_csv(self, path: str) -> None:
        """One row per (window, site): the timeline in spreadsheet form,
        with per-window savings repeated per row for easy pivoting."""
        from repro_torch.trace.report import write_csv
        cols = ("window", "n_requests", "partial", "site", "choice",
                "raw_winner", "flipped_from", "saving_fixed",
                "saving_online", "saving_oracle", "saving_actuated")
        rows = []
        for w in self.windows:
            flipped = {f.site: f.old for f in w.flips}
            for site in sorted(w.choices):
                rows.append((w.window, w.n_requests, int(w.partial), site,
                             w.choices[site], w.raw_choices[site],
                             flipped.get(site, ""), w.saving_fixed,
                             w.saving_online, w.saving_oracle,
                             w.saving_actuated))
        write_csv(path, cols, rows)

    def table(self, max_windows: int = 24) -> str:
        """Human-readable flip timeline (the example/CLI view)."""
        hdr = (f"{'win':>4s} {'req':>4s} {'fixed%':>7s} {'online%':>8s} "
               f"{'oracle%':>8s}  choices / flips")
        lines = [hdr, "-" * len(hdr)]
        for w in self.windows[-max_windows:]:
            orc = (f"{w.saving_oracle * 100:8.2f}"
                   if w.saving_oracle == w.saving_oracle else " " * 8)
            names = sorted(w.choices)
            # "prefill/layer0/wq" -> "p:layer0/wq" (keep phase distinct)
            short = {}
            for s in names:
                head, _, rest = s.partition("/")
                short[s] = f"{head[0]}:{rest}" if rest else s
            picks = " ".join(f"{short[s]}={w.choices[s]}" for s in names)
            for f in w.flips:
                picks += f"  [{short.get(f.site, f.site)}: {f.old}->{f.new}]"
            mark = "*" if w.partial else " "
            lines.append(
                f"{w.window:4d}{mark}{w.n_requests:4d} "
                f"{w.saving_fixed * 100:7.2f} {w.saving_online * 100:8.2f} "
                f"{orc}  {picks}")
        sm = self.summary()
        lines.append("-" * len(hdr))
        tail = (f"{sm['n_windows']} windows, {sm['n_requests']} requests, "
                f"{sm['n_flips']} flips")
        if self.swaps:
            tail += f", {len(self.swaps)} swaps"
        if "saving_online" in sm:
            tail += (f" | saving fixed {sm['saving_fixed'] * 100:.2f}% / "
                     f"online {sm['saving_online'] * 100:.2f}%")
            if "saving_oracle" in sm:
                tail += f" / oracle {sm['saving_oracle'] * 100:.2f}%"
            if self.swaps:
                tail += f" / actuated {sm['saving_actuated'] * 100:.2f}%"
        lines.append(tail)
        return "\n".join(lines)


class OnlineSelector:
    """Re-select per site on every closed window, with hysteresis.

    Feed closed :class:`Window` objects to :meth:`observe` (the registry
    fires it as an ``on_window`` hook); read :attr:`timeline`. Call
    :meth:`finalize` once at end of run to fill the oracle-static track.
    """

    def __init__(self, tcfg: TelemetryConfig,
                 mcfg: monitor.MonitorConfig = monitor.DEFAULT_MONITOR):
        self.tcfg = tcfg
        self.mcfg = mcfg
        names = mcfg.design_names
        bad = [c for c in (tcfg.candidates or ()) if c not in names]
        if bad:
            raise ValueError(
                f"telemetry candidates {bad} not in the monitor's design "
                f"list {names}; selection can only choose among designs "
                f"the accountant priced")
        self.candidates = tuple(tcfg.candidates) or names
        self.reference = mcfg.reference_design
        self.primary = mcfg.primary_design
        self.timeline = SelectionTimeline(
            reference=self.reference, primary=self.primary,
            candidates=self.candidates)
        self._current: dict[str, str] = {}   # site -> incumbent design
        self._dwell: dict[str, int] = {}     # consecutive windows held
        # staged-but-not-yet-applied flips (tcfg.actuate only): the
        # engine drains these at its next step boundary via take_pending
        self._pending: dict[str, str] = {}
        self._pending_old: dict[str, str] = {}
        self._pending_deltas: dict[str, float] = {}
        self._pending_window = -1

    # ---------------------------------------------------------- actuation
    def take_pending(self) -> tuple[dict[str, str], dict[str, float], int]:
        """Drain the staged flips: ``(site -> new design, site -> fJ
        delta on the staging window, last staging window index)``.
        Empty mapping when nothing is staged."""
        out = (dict(self._pending), dict(self._pending_deltas),
               self._pending_window)
        self._pending.clear()
        self._pending_old.clear()
        self._pending_deltas.clear()
        return out

    # ------------------------------------------------------------ windows
    def observe(self, window: Window) -> WindowSelection:
        counters = window.site_counters()
        sel = select_counters(counters, reference=self.reference,
                              primary=self.primary,
                              candidates=self.candidates)
        # every priced design's per-site window total (not just the
        # candidates: the fixed/reference tracks need theirs too)
        priced = {site: monitor.counters_to_energy(dict(c))
                  for site, c in counters.items()}
        energies = {
            site: {name: float(comps["total"])
                   for name, comps in designs.items()}
            for site, designs in priced.items()}
        flips: list[FlipEvent] = []
        choices: dict[str, str] = {}
        for site, raw in sel.choices.items():
            inc = self._current.get(site)
            if inc is None:                    # first sight: adopt raw pick
                self._current[site] = raw
                self._dwell[site] = 1
                choices[site] = raw
                continue
            e = energies[site]
            pick = inc
            if raw != inc and self._dwell[site] >= self.tcfg.min_dwell:
                margin = 1.0 - e[raw] / max(e[inc], 1e-30)
                if margin > self.tcfg.hysteresis:
                    flips.append(FlipEvent(window=window.index, site=site,
                                           old=inc, new=raw, margin=margin))
                    pick = raw
            if pick == inc:
                self._dwell[site] += 1
            else:
                self._current[site] = pick
                self._dwell[site] = 1
            choices[site] = pick
        names = set(self.candidates) | {self.reference, self.primary}
        energy = {name: sum(e[name] for e in energies.values())
                  for name in names}
        energy["online"] = sum(energies[s][choices[s]] for s in choices)
        # the AS-RECORDED track: each record's swap epochs priced under
        # the design active when its counters were recorded. Grouped
        # counters-first like the fixed track, so on swap-free traffic
        # (actuation off, or no commit yet) it equals fixed bit-exactly.
        energy["actuated"] = actuated_stream_energy(window.records,
                                                    self.primary)
        ref = max(energy[self.reference], 1e-30)
        if self.tcfg.actuate and flips:
            # stage the committed flips for the engine's next step
            # boundary, priced on the window that drove them
            old = {f.site: self._pending_old.get(f.site, f.old)
                   for f in flips}
            new = {f.site: f.new for f in flips}
            for site, d in swap_deltas(priced, old, new).items():
                self._pending_deltas[site] = d
            self._pending.update(new)
            self._pending_old.update(old)
            self._pending_window = window.index
        ws = WindowSelection(
            window=window.index, n_requests=window.n_requests,
            new_tokens=window.new_tokens, partial=window.partial,
            choices=choices, raw_choices=dict(sel.choices), flips=flips,
            energy=energy,
            saving_fixed=1.0 - energy[self.primary] / ref,
            saving_online=1.0 - energy["online"] / ref,
            saving_actuated=1.0 - energy["actuated"] / ref)
        self.timeline.windows.append(ws)
        return ws

    # ----------------------------------------------------------- finalize
    def finalize(self, registry) -> SelectionTimeline:
        """Fill the oracle-static track: the best per-site STATIC choice
        given the whole run's counters (the offline, full-hindsight
        answer), evaluated per window so every timeline entry reports
        saving_oracle alongside fixed/online."""
        merged: dict[str, dict[str, float]] = {}
        for rec in registry.records:
            for sr in rec.sites:
                acc = merged.setdefault(sr.site, {})
                for k, v in sr.counters.items():
                    if k == "zero_fraction":
                        continue
                    acc[k] = acc.get(k, 0.0) + float(v)
        if not merged:
            return self.timeline
        oracle = select_counters(merged, reference=self.reference,
                                 primary=self.primary,
                                 candidates=self.candidates)
        self.timeline.oracle_choices = dict(oracle.choices)
        # re-price each window under the static oracle assignment
        windows = {w.index: w for w in registry.windows}
        for ws in self.timeline.windows:
            counters = windows[ws.window].site_counters()
            e_orc = 0.0
            for site, c in counters.items():
                designs = monitor.counters_to_energy(dict(c))
                choice = oracle.choices.get(site, self.primary)
                e_orc += float(designs[choice]["total"])
            ws.energy["oracle"] = e_orc
            ws.saving_oracle = 1.0 - e_orc / max(
                ws.energy[self.reference], 1e-30)
        return self.timeline
