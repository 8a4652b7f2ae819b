"""Per-site design selection: the paper's application-aware choice, automated.

The paper picks WHAT to encode from the switching statistics of each
stream (BIC where mantissa entropy is high, ZVG where zeros are common).
Given per-site energies for a list of candidate designs -- e.g. one
analysed CNN layer per site -- this module makes that choice per matmul
site: greedily take the design with the lowest total energy at each
site. Because the candidate set contains the fixed
paper-proposed design (and the baseline itself), the selected network
energy is <= the fixed design's by construction; the interesting output
is WHERE the greedy choice differs (e.g. zero-free stem convolutions
drop ZVG's detector overhead, tiny-K sites drop the BIC encoder).

The result is reported as a ``"selected"`` pseudo-design that rides
through the same tables/aggregates as real designs.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

#: name of the injected pseudo-design
SELECTED = "selected"


@dataclasses.dataclass(frozen=True)
class Selection:
    """Outcome of per-site greedy selection."""
    choices: dict[str, str]      # site name -> chosen design name
    changed: dict[str, str]      # sites whose choice != the fixed primary
    saving_total: float          # selected vs reference (energies-first)
    saving_primary: float        # fixed primary vs reference
    reference: str
    primary: str

    def summary(self) -> dict:
        return {
            "n_sites": len(self.choices),
            "n_changed": len(self.changed),
            "designs_used": sorted(set(self.choices.values())),
            "saving_selected": self.saving_total,
            "saving_fixed": self.saving_primary,
            "reference": self.reference,
            "primary": self.primary,
        }


def select_sites(site_designs: Mapping[str, Mapping[str, Mapping]],
                 reference: str = "baseline",
                 primary: str = "proposed",
                 candidates: Sequence[str] | None = None) -> Selection:
    """Greedy per-site choice over ``{site: {design: {"total": fJ, ...}}}``.

    ``candidates`` restricts the choice set (default: every design
    present at the first site, including the reference -- "encode
    nothing" is a legitimate per-site choice). Savings are computed the
    paper's way: energies summed across sites first, one ratio at the
    end.
    """
    choices: dict[str, str] = {}
    changed: dict[str, str] = {}
    tot_ref = tot_primary = tot_sel = 0.0
    for site, designs in site_designs.items():
        names = [n for n in (candidates or designs) if n != SELECTED]
        missing = [n for n in names if n not in designs]
        if missing:
            raise KeyError(f"site {site!r} has no energies for {missing}")
        best = min(names, key=lambda n: float(designs[n]["total"]))
        choices[site] = best
        if best != primary:
            changed[site] = best
        tot_ref += float(designs[reference]["total"])
        tot_primary += float(designs[primary]["total"])
        tot_sel += float(designs[best]["total"])
    denom = max(tot_ref, 1e-30)
    return Selection(
        choices=choices, changed=changed,
        saving_total=1.0 - tot_sel / denom,
        saving_primary=1.0 - tot_primary / denom,
        reference=reference, primary=primary)


def swap_deltas(site_designs: Mapping[str, Mapping[str, Mapping]],
                old_choices: Mapping[str, str],
                new_choices: Mapping[str, str],
                component: str = "total") -> dict[str, float]:
    """Per-site energy deltas (fJ, new minus old) of a staged swap set,
    straight off per-site design energies -- no report rebuild.

    This is the actuation path's pricing primitive: when the online
    selector commits flips, the engine needs "what does swapping THESE
    sites cost/save on the window that drove the flip" without
    re-aggregating a TraceReport. Sites whose choice did not change are
    omitted; a negative delta means the new design is cheaper."""
    out: dict[str, float] = {}
    for site, new in new_choices.items():
        old = old_choices.get(site, new)
        if old == new:
            continue
        designs = site_designs[site]
        missing = [n for n in (old, new) if n not in designs]
        if missing:
            raise KeyError(f"site {site!r} has no energies for {missing}")
        out[site] = (float(designs[new][component])
                     - float(designs[old][component]))
    return out


def select_counters(site_counters: Mapping[str, Mapping[str, float]],
                    reference: str = "baseline",
                    primary: str = "proposed",
                    candidates: Sequence[str] | None = None) -> Selection:
    """Greedy selection straight off accumulated flat counters: the
    incremental re-selection path. ``site_counters`` maps a site name to
    summed :func:`repro_torch.core.monitor.stream_counters` keys (a
    counter delta: one telemetry window's fold, or the difference of two
    snapshots). Each site's delta is priced with ``counters_to_energy``
    and fed to :func:`select_sites`; counters add across calls, so
    selecting over a delta is selecting over that slice of traffic."""
    from repro_torch.core import monitor
    site_designs = {site: monitor.counters_to_energy(dict(counters))
                    for site, counters in site_counters.items()}
    return select_sites(site_designs, reference=reference, primary=primary,
                        candidates=candidates)


def pareto_front(objectives: Sequence[Sequence[float]]) -> list[int]:
    """Indices of the non-dominated points, every objective MINIMIZED.

    Point ``i`` is dominated when some other point is <= on every
    objective and strictly < on at least one. A design-space sweep calls
    this on ``(energy, accuracy_proxy)`` pairs; kept generic (any number of
    objectives, plain floats) so geometry/latency axes can join later.
    Duplicated points keep every copy (none strictly improves on the
    other), and the returned indices preserve input order. O(n^2) --
    design grids are hundreds of points, not millions.
    """
    pts = [tuple(float(v) for v in p) for p in objectives]
    front = []
    for i, p in enumerate(pts):
        dominated = any(
            all(qv <= pv for qv, pv in zip(q, p))
            and any(qv < pv for qv, pv in zip(q, p))
            for j, q in enumerate(pts) if j != i)
        if not dominated:
            front.append(i)
    return front


def apply_selection(report, candidates: Sequence[str] | None = None
                    ) -> Selection:
    """Greedy selection over a :class:`repro_torch.trace.TraceReport`,
    injected in place: each site gains a ``"selected"`` entry (a copy of
    its winner's energies) in ``site.designs`` and names the winner in
    ``site.selected``; ``report.designs`` gains ``"selected"`` so the
    aggregates and the table pick it up. Returns the :class:`Selection`.
    """
    site_designs = {s.name: s.designs for s in report.sites}
    sel = select_sites(site_designs, reference=report.reference,
                       primary=report.primary, candidates=candidates)
    for s in report.sites:
        chosen = sel.choices[s.name]
        s.designs[SELECTED] = dict(s.designs[chosen])
        s.selected = chosen
    if SELECTED not in report.designs:
        report.designs = tuple(report.designs) + (SELECTED,)
    return sel
