"""Per-layer SA streaming/power analysis of CNN inference (paper Figs. 4/5).

For every lowered matmul of a CNN forward pass, stream the exact operands
through the systolic-array activity model once and price any list of
:class:`repro_torch.design.DesignPoint`\\ s -- by default the paper pair
(conventional vs BIC + ZVG), whose numbers the twin fields of
:class:`LayerPower` carry.

Depthwise convolutions are analysed as their true SA mapping: C
independent ``[M, 9] x [9, 1]`` matmuls, priced as one batch (one counter
launch per edge for all channels).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import design as D
from repro_torch.apps import check_device
from repro_torch.core import bic, power, systolic
from repro_torch.runtime import spans

from . import nets


@dataclasses.dataclass
class LayerPower:
    name: str
    kind: str
    macs: float
    zero_fraction: float
    activity_reduction: float
    power_base: float        # fJ / cycle
    power_prop: float
    saving_total: float
    saving_streaming: float
    energy_base: float       # fJ
    energy_prop: float
    streaming_share: float
    #: per-design totals: {name: {"total", "streaming", "h", "v"}}
    designs: dict = dataclasses.field(default_factory=dict)
    reference: str = "baseline"
    primary: str = "proposed"
    selected: str = ""

    def saving(self, name: str) -> float:
        ref = max(float(self.designs[self.reference]["total"]), 1e-30)
        return 1.0 - float(self.designs[name]["total"]) / ref


def _design_list(geom, segs, em) -> tuple[D.DesignPoint, ...]:
    return D.paper_pair(geom, tuple(segs), True, em)


def matmul_operands(trace: nets.LayerTrace):
    """The operands the SA streams for one traced layer: ``(A, W)``, or
    for a depthwise layer its C per-channel problems ``[C, M, k2]`` x
    ``[C, k2, 1]``."""
    if trace.kind != "dwconv":
        return trace.A, trace.W
    M = trace.A.shape[0]
    k2, C = trace.W.shape
    return (trace.A.reshape(M, k2, C).permute(2, 0, 1),    # [C, M, k2]
            trace.W.T[:, :, None])                         # [C, k2, 1]


def analyze_trace(trace: nets.LayerTrace,
                  geom: systolic.SAGeometry = systolic.PAPER_SA,
                  segs: Sequence[int] = bic.MANTISSA_ONLY,
                  em: power.EnergyModel = power.DEFAULT_ENERGY,
                  designs: Sequence[D.DesignPoint] = (),
                  backend: str | None = None) -> LayerPower:
    """Price one traced layer for ``designs`` (default: the paper pair
    built from ``geom``/``segs``/``em``) from a single stream pass, on
    the device the operands live on."""
    with spans.span("cnn.site"):
        return _analyze_trace(trace, geom, segs, em, designs, backend)


def _analyze_trace(trace, geom, segs, em, designs, backend) -> LayerPower:
    designs = tuple(designs) or _design_list(geom, tuple(segs), em)
    A, W = matmul_operands(trace)
    if trace.kind == "dwconv":
        ev = D.evaluate_batched(A, W, designs, backend)
    else:
        ev = D.evaluate_operands(A, W, designs, backend)

    reference, primary = designs[0].name, designs[min(1, len(designs)-1)].name
    ref, pri = ev[reference], ev[primary]
    cyc = max(float(ref["cycles"]), 1.0)
    eb, ep = float(ref["energy"]["total"]), float(pri["energy"]["total"])
    sb = float(ref["energy"]["streaming"])
    sp = float(pri["energy"]["streaming"])
    hv_ref = float(ref["h"]) + float(ref["v"])
    hv_pri = float(pri["h"]) + float(pri["v"])
    return LayerPower(
        name=trace.name, kind=trace.kind, macs=trace.macs,
        zero_fraction=float(ref["zero_fraction"]),
        activity_reduction=1.0 - hv_pri / max(hv_ref, 1.0),
        power_base=eb / cyc,
        power_prop=ep / cyc,
        saving_total=1.0 - ep / max(eb, 1.0),
        saving_streaming=1.0 - sp / max(sb, 1.0),
        energy_base=eb, energy_prop=ep,
        streaming_share=sb / max(eb, 1e-30),
        designs={name: {"total": float(r["energy"]["total"]),
                        "streaming": float(r["energy"]["streaming"]),
                        "h": float(r["h"]), "v": float(r["v"])}
                 for name, r in ev.items()},
        reference=reference, primary=primary)


def analyze_network(net: str, n_images: int = 2, seed: int = 0,
                    geom: systolic.SAGeometry = systolic.PAPER_SA,
                    segs: Sequence[int] = bic.MANTISSA_ONLY,
                    em: power.EnergyModel = power.DEFAULT_ENERGY,
                    designs: Sequence[D.DesignPoint] = (),
                    device: str | torch.device = "cuda",
                    res: int = 224) -> list[LayerPower]:
    """Full per-layer analysis of a CNN (paper Figs. 4/5 data) on
    ``n_images`` synthetic ``res`` px images, run on ``device``."""
    device = check_device(device, "the analysis")
    images = nets.synthetic_images(n_images, res, seed=seed + 7,
                                   device=device)
    traces = nets.forward_with_traces(net, images, seed=seed)
    return [analyze_trace(t, geom, segs, em, designs) for t in traces]


def select_network(layers: list[LayerPower],
                   candidates: Sequence[str] | None = None) -> D.Selection:
    """Greedy per-layer design choice over an ``analyze_network`` result
    (multi-design run required); marks each layer's ``selected``."""
    with spans.span("cnn.select"):
        sel = D.select_sites({l.name: l.designs for l in layers},
                             reference=layers[0].reference,
                             primary=layers[0].primary,
                             candidates=candidates)
        for l in layers:
            l.selected = sel.choices[l.name]
        return sel


def network_summary(layers: list[LayerPower]) -> dict:
    """Energy-weighted network aggregates (paper's 'overall' numbers)."""
    with spans.span("cnn.select"):
        tb = sum(l.energy_base for l in layers)
        tp = sum(l.energy_prop for l in layers)
        act = [l.activity_reduction for l in layers]
        savings = [l.saving_total for l in layers]
        return {
            "overall_power_reduction": 1.0 - tp / tb,
            "mean_activity_reduction": sum(act) / len(act),
            "mean_zero_fraction": (sum(l.zero_fraction for l in layers)
                                   / len(layers)),
            "per_layer_saving_min": min(savings),
            "per_layer_saving_max": max(savings),
            "n_layers": len(layers),
        }
