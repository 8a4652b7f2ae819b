"""Per-site and model-level power reports.

:func:`build_report` freezes a :class:`repro_torch.trace.capture.
TraceCapture` into a :class:`TraceReport`: one :class:`SitePower` row per
matmul site, each carrying ``{design name: {"total", "streaming", "h",
"v"}}``, and aggregates computed the paper's way -- energies summed over
sites *before* taking ratios
(:func:`repro_torch.core.power.aggregate_savings`). Savings are relative
to the ``reference`` design (first of the monitor's list); headline
numbers quote the ``primary`` design (the second). Reports serialize to
JSON (round-trippable), CSV and a text table.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core import power

from .capture import TraceCapture

#: derived per-site scalars written to JSON for readers; rebuilt from
#: ``designs`` on load, never parsed back
_DERIVED = ("activity_reduction", "saving_total", "saving_streaming",
            "streaming_share")


def write_json(path: str, payload: dict) -> None:
    """Write one JSON artifact (indent=1, so diffs stay line-per-field)."""
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def write_csv(path: str, cols, rows) -> None:
    """Write a header + rows CSV; every cell is ``str()``-formatted."""
    with open(path, "w") as f:
        f.write(",".join(str(c) for c in cols) + "\n")
        for row in rows:
            f.write(",".join(str(v) for v in row) + "\n")


@dataclasses.dataclass
class SitePower:
    """One matmul site's accumulated power outcome (fJ, estimated full)."""
    name: str
    kind: str
    shape: tuple[int, int, int, int]   # (B, M, K, N)
    calls: int
    sampled_calls: int
    macs: float                        # across all calls
    zero_fraction: float               # mean over sampled calls
    designs: dict[str, dict]
    reference: str = "baseline"
    primary: str = "proposed"
    selected: str = ""                 # per-site winning design, if chosen

    def energy(self, design: str, component: str = "total") -> float:
        return float(self.designs[design][component])

    def saving(self, design: str, component: str = "total") -> float:
        ref = max(self.energy(self.reference, component), 1e-30)
        return 1.0 - self.energy(design, component) / ref

    @property
    def saving_total(self) -> float:
        return self.saving(self.primary)

    @property
    def saving_streaming(self) -> float:
        return self.saving(self.primary, "streaming")

    @property
    def streaming_share(self) -> float:
        return (self.energy(self.reference, "streaming")
                / max(self.energy(self.reference), 1e-30))

    @property
    def activity_reduction(self) -> float:
        ref = self.designs[self.reference]
        pri = self.designs[self.primary]
        denom = max(float(ref["h"]) + float(ref["v"]), 1e-30)
        return 1.0 - (float(pri["h"]) + float(pri["v"])) / denom

    def power_report(self, primary: str | None = None) -> dict:
        """Shape-compatible with ``power.aggregate_savings`` input."""
        pri = self.designs[primary or self.primary]
        ref = self.designs[self.reference]
        return {"baseline": {"total": float(ref["total"]),
                             "streaming": float(ref["streaming"])},
                "proposed": {"total": float(pri["total"]),
                             "streaming": float(pri["streaming"])}}


@dataclasses.dataclass
class TraceReport:
    model: str
    geometry: tuple[int, int]
    bic_segments: tuple[int, ...]
    sites: list[SitePower]
    skipped: tuple[str, ...] = ()
    designs: tuple[str, ...] = ("baseline", "proposed")
    reference: str = "baseline"
    primary: str = "proposed"

    # ---------------------------------------------------------- aggregates
    def aggregate_design(self, design: str) -> dict:
        """Model-level savings of ``design`` vs the reference, energies
        summed over every site before the ratio."""
        if not self.sites:
            return {"total_saving": 0.0, "streaming_saving": 0.0,
                    "streaming_share": 0.0}
        return power.aggregate_savings(
            [s.power_report(design) for s in self.sites])

    def aggregate(self) -> dict:
        """The primary design's aggregate (the headline)."""
        return self.aggregate_design(self.primary)

    def summary(self) -> dict:
        agg = self.aggregate()
        macs = sum(s.macs for s in self.sites)
        zf = (sum(s.zero_fraction * s.macs for s in self.sites)
              / max(macs, 1.0))
        per_design = {d: self.aggregate_design(d)["total_saving"]
                      for d in self.designs if d != self.reference}
        return {
            "model": self.model,
            "geometry": f"{self.geometry[0]}x{self.geometry[1]}",
            "n_sites": len(self.sites),
            "n_calls": sum(s.calls for s in self.sites),
            "macs": macs,
            "mean_zero_fraction": zf,
            **agg,
            "design_savings": per_design,
        }

    # ------------------------------------------------------- serialization
    def to_json_dict(self) -> dict:
        sites = []
        for s in self.sites:
            d = dataclasses.asdict(s)
            d["shape"] = list(s.shape)
            d.update({k: getattr(s, k) for k in _DERIVED})
            sites.append(d)
        return {
            "model": self.model,
            "geometry": list(self.geometry),
            "bic_segments": list(self.bic_segments),
            "designs": list(self.designs),
            "reference": self.reference,
            "primary": self.primary,
            "skipped": list(self.skipped),
            "summary": self.summary(),
            "sites": sites,
        }

    def to_json(self, path: str) -> None:
        write_json(path, self.to_json_dict())

    @classmethod
    def from_json_dict(cls, d: dict) -> "TraceReport":
        sites = []
        for s in d["sites"]:
            s = {k: v for k, v in s.items() if k not in _DERIVED}
            s["shape"] = tuple(s["shape"])
            sites.append(SitePower(**s))
        return cls(model=d["model"], geometry=tuple(d["geometry"]),
                   bic_segments=tuple(d["bic_segments"]), sites=sites,
                   skipped=tuple(d.get("skipped", ())),
                   designs=tuple(d["designs"]), reference=d["reference"],
                   primary=d["primary"])

    @classmethod
    def from_json(cls, path: str) -> "TraceReport":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))

    def to_csv(self, path: str) -> None:
        cols = ("name", "kind", "calls", "B", "M", "K", "N", "macs",
                "zero_fraction", "activity_reduction", "saving_total",
                "saving_streaming", "streaming_share", "selected")
        cols += tuple(f"energy_{d}" for d in self.designs)
        rows = []
        for s in self.sites:
            b, m, k, n = s.shape
            vals = (s.name, s.kind, s.calls, b, m, k, n, s.macs,
                    s.zero_fraction, s.activity_reduction,
                    s.saving_total, s.saving_streaming,
                    s.streaming_share, s.selected)
            vals += tuple(s.designs[d]["total"] if d in s.designs
                          else "" for d in self.designs)
            rows.append(vals)
        write_csv(path, cols, rows)

    def table(self, max_rows: int = 40) -> str:
        """The per-site text table (largest reference energy first, at
        most ``max_rows`` rows) and the model's aggregate line."""
        with_sel = any(s.selected for s in self.sites)
        hdr = (f"{'site':52s} {'kind':8s} {'calls':>5s} "
               f"{'B,M,K,N':>18s} {'zero%':>6s} {'act-red%':>8s} "
               f"{'save%':>6s}")
        if with_sel:
            hdr += f" {'best':>9s} {'best%':>6s}"
        lines = [hdr, "-" * len(hdr)]
        shown = sorted(self.sites, key=lambda s: -s.energy(s.reference))
        for s in shown[:max_rows]:
            b, m, k, n = s.shape
            name = s.name if len(s.name) <= 52 else "..." + s.name[-49:]
            line = (
                f"{name:52s} {s.kind:8s} {s.calls:5d} "
                f"{f'{b},{m},{k},{n}':>18s} {s.zero_fraction*100:6.1f} "
                f"{s.activity_reduction*100:8.1f} {s.saving_total*100:6.1f}")
            if with_sel:
                line += (f" {s.selected:>9s} "
                         f"{s.saving(s.selected)*100:6.1f}"
                         if s.selected else " " * 17)
            lines.append(line)
        if len(shown) > max_rows:
            lines.append(f"... ({len(shown) - max_rows} more sites)")
        sm = self.summary()
        lines.append("-" * len(hdr))
        lines.append(
            f"{self.model}: {len(self.sites)} sites, "
            f"{sm['macs']:.3g} MACs | mean zero "
            f"{sm['mean_zero_fraction']*100:.1f}% "
            f"| streaming saving {sm['streaming_saving']*100:.1f}% "
            f"| total saving {sm['total_saving']*100:.1f}% "
            f"(streaming share {sm['streaming_share']*100:.1f}%)")
        extra = {d: v for d, v in sm["design_savings"].items()
                 if d != self.primary}
        if extra:
            lines.append("designs vs " + self.reference + ": " + "  ".join(
                f"{d}={v*100:.1f}%" for d, v in extra.items()))
        return "\n".join(lines)


def build_report(cap: TraceCapture, model: str,
                 skipped: tuple[str, ...] = ()) -> TraceReport:
    """Freeze a capture registry into a :class:`TraceReport`."""
    mcfg = cap.cfg.monitor
    reference = mcfg.reference_design
    primary = mcfg.primary_design
    sites = []
    for acc in cap.sites.values():
        e = cap.site_energy(acc)
        tog = cap.site_toggles(acc)
        designs = {
            name: {"total": comps.get("total", 0.0),
                   "streaming": comps.get("streaming", 0.0),
                   "h": tog.get(name, {}).get("h", 0.0),
                   "v": tog.get(name, {}).get("v", 0.0)}
            for name, comps in e.items()}
        sites.append(SitePower(
            name=acc.name, kind=acc.kind, shape=acc.shape,
            calls=acc.calls, sampled_calls=acc.sampled_calls,
            macs=acc.macs,
            zero_fraction=acc.zf_sum / max(acc.sampled_calls, 1),
            designs=designs, reference=reference, primary=primary))
    geom = mcfg.design_list[0].geometry
    if mcfg.designs:
        # explicit design list: record the primary design's north-bus
        # segments (if any), what was actually priced
        prim = next(d for d in mcfg.design_list if d.name == primary)
        segments = prim.north.bic or ()
    else:
        segments = mcfg.bic_segments
    return TraceReport(
        model=model, geometry=(geom.rows, geom.cols),
        bic_segments=tuple(int(s) for s in segments),
        sites=sites, skipped=tuple(skipped),
        designs=mcfg.design_names, reference=reference, primary=primary)
