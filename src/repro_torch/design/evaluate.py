"""N-design evaluation: price any set of DesignPoints from one stream pass.

1. :func:`repro_torch.core.systolic.sa_design_report` walks the operands
   ONCE and tabulates a coding menu per edge plus the coding-independent
   facts.
2. :func:`design_energy` / :func:`evaluate` pick each design's entries off
   that menu and price them with
   :func:`repro_torch.core.power.price_components`.

Evaluation is per-design independent: the result does not depend on the
order of the design list, and a single-design evaluation equals the
corresponding slice of any multi-design evaluation.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import power, systolic
from repro_torch.core.systolic import seg_key

from .point import Coding, DesignPoint


def _check_names(designs: Sequence[DesignPoint]) -> None:
    names = [d.name for d in designs]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate design names {dupes}")


def menu_args(designs: Sequence[DesignPoint]
              ) -> dict[tuple[systolic.SAGeometry, str], dict]:
    """:func:`sa_design_report` arguments per stream group: the union of
    menu entries the designs need, grouped by the ``(geometry,
    precision)`` pair they share a stream pass with."""
    groups: dict[tuple[systolic.SAGeometry, str], dict] = {}
    for d in designs:
        g = groups.setdefault((d.geometry, d.precision), {
            "west_bic": [], "north_bic": [],
            "west_zvg": False, "north_zvg": False})
        for edge, c in (("west", d.west), ("north", d.north)):
            if c.bic is not None and c.bic not in g[f"{edge}_bic"]:
                g[f"{edge}_bic"].append(c.bic)
            if c.zvg:
                g[f"{edge}_zvg"] = True
    # sorted variant tuples: design-list order never changes the pass
    return {key: {"west_bic": tuple(sorted(g["west_bic"])),
                  "north_bic": tuple(sorted(g["north_bic"])),
                  "west_zvg": g["west_zvg"],
                  "north_zvg": g["north_zvg"]}
            for key, g in groups.items()}


def _edge_toggles(report: dict, prefix: str, c: Coding):
    """Per-stream transition count of one edge under one coding (before
    multiplication by the pipeline path length)."""
    if c.zvg and c.bic is not None:
        return (report[f"{prefix}_bic_zvg/{seg_key(c.bic)}"]
                + report[f"{prefix}_iszero"])
    if c.zvg:
        return report[f"{prefix}_zvg"] + report[f"{prefix}_iszero"]
    if c.bic is not None:
        return report[f"{prefix}_bic/{seg_key(c.bic)}"]
    return report[f"{prefix}_raw"]


def _mult_toggles(report: dict, prefix: str, c: Coding, mant: bool):
    """Operand toggles as seen by the multipliers: BIC is decoded at the
    PE (the datapath sees raw values), ZVG holds the operand register."""
    field = "mant_" if mant else ""
    if c.zvg:
        return report[f"{prefix}_{field}zvg"]
    return report[f"{prefix}_{field}raw"]


def design_energy(report: dict, design: DesignPoint) -> dict:
    """Price ONE design from a :func:`sa_design_report` menu.

    Returns ``{"energy": {component: fJ, ..., "total": fJ},
    "h": horizontal-pipeline toggles, "v": vertical-pipeline toggles,
    "cycles": ..., "zero_fraction": ...}``. The menu must have been built
    for ``design.geometry`` and ``design.precision`` with this design's
    codings included (see :func:`menu_args`); a missing entry raises
    ``KeyError``.
    """
    em = design.priced_energy()
    cw, cn = design.west, design.north
    R, C = design.geometry.rows, design.geometry.cols
    Mp, Np = report["Mp"], report["Np"]
    Tm, Tn = report["Tm"], report["Tn"]
    active_frac = report["active_frac"]

    # pipeline register/wire toggles = per-stream transitions x path length
    h_tog = Tn * C * _edge_toggles(report, "w", cw)
    v_tog = Tm * R * _edge_toggles(report, "n", cn)

    # multiplier operand toggles (b-side masked by the input-active
    # fraction in every design)
    a_tog = Np * _mult_toggles(report, "w", cw, mant=False)
    a_mant = Np * _mult_toggles(report, "w", cw, mant=True)
    b_tog = active_frac * Mp * _mult_toggles(report, "n", cn, mant=False)
    b_mant = active_frac * Mp * _mult_toggles(report, "n", cn, mant=True)

    # clock/compute gating from zero values, per gated edge;
    # inclusion-exclusion removes the doubly-counted both-zero slots
    gated = 0.0
    if cw.zvg:
        gated = Np * report["w_zeros"]
    if cn.zvg:
        gated = gated + Mp * report["n_zeros"]
        if cw.zvg:
            gated = gated - report["gated_overlap"]

    # proposed-logic overheads, per coded edge (canonical order: zero
    # detectors, BIC encoders, per-PE decode XORs)
    overhead = 0.0
    if cw.zvg:
        overhead = overhead + em.E_ZDET * report["west_words"]
    if cn.zvg:
        overhead = overhead + em.E_ZDET * report["north_words"]
    if cw.bic is not None:
        overhead = overhead + em.E_ENC * report["west_words"]
    if cn.bic is not None:
        overhead = overhead + em.E_ENC * report["north_words"]
    if cw.bic is not None:
        overhead = overhead + em.E_DEC_XOR_BIT * em.MANT_FRAC * a_tog
    if cn.bic is not None:
        overhead = overhead + em.E_DEC_XOR_BIT * em.MANT_FRAC * b_tog

    comps = power.price_components(
        em, cyc=torch.clamp_min(report["cycles"], 1.0),
        n_pe=report["rows"] * report["cols"],
        pe_slots=report["pe_slots"], gated=gated,
        nonzero=report["nonzero_slots"],
        h_toggles=h_tog, v_toggles=v_tog,
        a_toggles=a_tog, b_toggles=b_tog, a_mant=a_mant, b_mant=b_mant,
        unload_trav=report["unload_reg_traversals"], overhead=overhead)
    return {"energy": comps, "h": h_tog, "v": v_tog,
            "cycles": report["cycles"],
            "zero_fraction": report["zero_fraction"]}


def evaluate(report: dict, designs: Sequence[DesignPoint]) -> dict:
    """Price every design in ``designs`` from one menu ``report``; they
    must share its geometry and precision (use :func:`evaluate_operands`
    to mix). Returns ``{design.name: design_energy(report, design)}``."""
    _check_names(designs)
    geoms = {d.geometry for d in designs}
    if len(geoms) > 1:
        raise ValueError(
            f"evaluate() prices one stream pass; designs span geometries "
            f"{sorted((g.rows, g.cols) for g in geoms)} -- use "
            f"evaluate_operands()")
    precisions = {d.precision for d in designs}
    if len(precisions) > 1:
        raise ValueError(
            f"evaluate() prices one stream pass; designs span precisions "
            f"{sorted(precisions)} (different operand formats are "
            f"different streams) -- use evaluate_operands()")
    return {d.name: design_energy(report, d) for d in designs}


def evaluate_operands(A: torch.Tensor, W: torch.Tensor,
                      designs: Sequence[DesignPoint],
                      backend: str | None = None) -> dict:
    """Stream ``[M,K] x [K,N]`` operands (or a batch ``[B,M,K] x
    [B,K,N]``, giving ``[B]`` values) and price every design: one
    :func:`sa_design_report` pass per distinct ``(geometry, precision)``
    group, with the union of the group's menu needs."""
    _check_names(designs)
    out: dict = {}
    for (geom, precision), kw in menu_args(designs).items():
        menu = systolic.sa_design_report(A, W, geom, backend=backend,
                                         precision=precision, **kw)
        for d in designs:
            if d.geometry == geom and d.precision == precision:
                out[d.name] = design_energy(menu, d)
    return out


def _batch_sum(v, n: int, wts=None) -> torch.Tensor:
    """Sum of a per-problem value over ``n`` problems (a 0-d value counts
    once per problem), weighted by ``wts``; accumulated in float64 and
    rounded once to float32."""
    v = torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32), (n,))
    if wts is not None:
        v = v * wts
    return v.to(torch.float64).sum().to(torch.float32)


def evaluate_batched(A3: torch.Tensor, W3: torch.Tensor,
                     designs: Sequence[DesignPoint],
                     backend: str | None = None,
                     weights: torch.Tensor | None = None) -> dict:
    """Batched form: ``[B,M,K] x [B,K,N]`` independent problems (grouped
    convolutions), priced per problem from ONE counter launch per edge
    for the whole batch, then energies, toggles and cycles summed over B
    and ``zero_fraction`` averaged.

    ``weights`` (``[B]``, optional) scales every extensive quantity of
    problem ``b`` before the sum (a sampled site standing for a larger
    one); ``zero_fraction`` becomes the weighted mean.
    """
    n = A3.shape[0]
    per = evaluate_operands(A3, W3, tuple(designs), backend)
    wts = None
    if weights is not None:
        wts = torch.as_tensor(weights, dtype=torch.float32).cpu()
        if tuple(wts.shape) != (n,):
            raise ValueError(
                f"weights must be [B]={n}, got {tuple(wts.shape)}")
        wsum = torch.clamp_min(wts.sum(), 1e-30)
    out = {}
    for name, r in per.items():
        zf = torch.broadcast_to(r["zero_fraction"], (n,))
        out[name] = {
            "energy": {k: _batch_sum(v, n, wts)
                       for k, v in r["energy"].items()},
            "h": _batch_sum(r["h"], n, wts),
            "v": _batch_sum(r["v"], n, wts),
            "cycles": _batch_sum(r["cycles"], n, wts),
            "zero_fraction": (zf.mean() if wts is None
                              else (zf * wts).sum() / wsum),
        }
    return out


def savings(evaluated: dict, reference: str = "baseline") -> dict:
    """Relative savings of every design vs ``reference`` (host-side).

    Returns ``{name: {"saving_total", "saving_streaming",
    "streaming_share"}}``, with the reference's streaming share under
    every design.
    """
    ref = evaluated[reference]["energy"]
    rt = max(float(ref["total"]), 1e-30)
    rs = max(float(ref["streaming"]), 1e-30)
    share = float(ref["streaming"]) / rt
    out = {}
    for name, r in evaluated.items():
        e = r["energy"]
        out[name] = {
            "saving_total": 1.0 - float(e["total"]) / rt,
            "saving_streaming": 1.0 - float(e["streaming"]) / rs,
            "streaming_share": share,
        }
    return out
