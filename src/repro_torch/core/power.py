"""Calibrated dynamic-power model for the systolic array.

Power is an explicit analytic model over the exact activity counters of
:mod:`repro_torch.core.systolic`:

    E_total = E_streaming + E_clock + E_compute + E_accumulate + E_unload
              (+ E_overhead for the proposed design's new logic)

Energy constants are in femtojoules, 45 nm-flavoured; the JAX package's
``repro.core.power`` documents their provenance and calibration.

Every formula here is written in the JAX package's operation order and
evaluated in float32 (0-d or ``[B]`` tensors, with Python floats as
constants), so the two packages price the same counters within a few
float32 roundings.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-event energies in fJ (45 nm-flavoured)."""
    E_REG_BIT: float = 6.0        # flip-flop data toggle
    E_WIRE_BIT: float = 18.0      # inter-PE wire toggle (calibrated)
    E_CLK_BIT: float = 1.8        # clock pin per flop-bit per ungated cycle
    E_MULT: float = 450.0         # bf16 multiply (8x8 mantissa) at random activity
    E_ADD: float = 400.0          # accumulate add (align + add + normalise)
    MULT_STATIC_FRAC: float = 0.01  # operand-independent share of E_MULT
    MULT_PP_FRAC: float = 0.80      # partial-product-array share of mult dyn
    ADD_STATIC_FRAC: float = 0.01
    ACC_TOGGLE_BITS: float = 12.8   # mean acc-register bits toggled per update
    UNLOAD_TOGGLE_BITS: float = 12.8
    REG_BITS_PER_PE: float = 72.0   # a(16) + b(16) + acc(32) + ctrl(8)
    GATEABLE_BITS_PER_PE: float = 42.0  # a-reg + acc + operand latch + ctrl
    E_ZDET: float = 8.0           # 16-bit zero comparator, per word
    E_ENC: float = 60.0           # mantissa BIC encoder, per word
    E_DEC_XOR_BIT: float = 0.8    # per decoded-bit toggle at each PE
    MANT_FRAC: float = 7.0 / 16.0  # mantissa share of weight-bus toggles
    MANT_BITS: float = 7.0        # multiplier-model mantissa width
    BUS_BITS: float = 16.0        # multiplier-model bus width
    E_CTRL_CYCLE: float = 160.0    # sequencing/mux control per PE per cycle
    CLK_LEAF_FRAC: float = 0.18   # share of clock power at gateable leaf pins

    @property
    def E_STREAM_BIT(self) -> float:
        return self.E_REG_BIT + self.E_WIRE_BIT


DEFAULT_ENERGY = EnergyModel()


def _mult_energy(em: EnergyModel, slots, tog_a, tog_b, mtog_a, mtog_b):
    """Multiplier energy: static share + toggle-scaled dynamic share
    (mantissa toggles drive the partial-product array, full-word toggles
    the exponent/sign path)."""
    static = em.MULT_STATIC_FRAC * em.E_MULT * slots
    dyn_budget = (1.0 - em.MULT_STATIC_FRAC) * em.E_MULT
    pp = em.MULT_PP_FRAC * dyn_budget * (mtog_a + mtog_b) / em.MANT_BITS
    exp = (1.0 - em.MULT_PP_FRAC) * dyn_budget * (tog_a + tog_b) / em.BUS_BITS
    return static + pp + exp


#: canonical per-design energy components, in total-summation order
#: (``overhead`` is 0 for uncoded designs)
COMPONENTS = ("streaming", "clock", "control", "mult", "add", "acc",
              "unload", "overhead")


def price_components(em: EnergyModel, *, cyc, n_pe, pe_slots, gated,
                     nonzero, h_toggles, v_toggles, a_toggles, b_toggles,
                     a_mant, b_mant, unload_trav, overhead) -> dict:
    """Energy components (fJ) of ONE design from its toggle/slot counts:
    the single pricing authority of the port. ``gated`` and ``overhead``
    are 0 for uncoded designs."""
    comps = {}
    comps["streaming"] = em.E_STREAM_BIT * (h_toggles + v_toggles)
    # gated slots drop the LEAF share of the gateable flops' clock load
    clk_full = em.E_CLK_BIT * em.REG_BITS_PER_PE * n_pe * cyc
    clk_saved = (em.E_CLK_BIT * em.GATEABLE_BITS_PER_PE
                 * em.CLK_LEAF_FRAC * gated)
    comps["clock"] = clk_full - clk_saved
    comps["control"] = em.E_CTRL_CYCLE * n_pe * cyc
    comps["mult"] = _mult_energy(em, pe_slots - gated,
                                 a_toggles, b_toggles, a_mant, b_mant)
    comps["add"] = em.E_ADD * (
        em.ADD_STATIC_FRAC * (pe_slots - gated)
        + (1 - em.ADD_STATIC_FRAC) * nonzero)
    comps["acc"] = em.E_REG_BIT * em.ACC_TOGGLE_BITS * nonzero
    comps["unload"] = (em.E_STREAM_BIT * em.UNLOAD_TOGGLE_BITS
                       * unload_trav)
    comps["overhead"] = overhead
    comps["total"] = sum(comps[k] for k in COMPONENTS)
    return comps


def sa_power(report: dict, em: EnergyModel = DEFAULT_ENERGY) -> dict:
    """Dynamic energy (fJ) breakdown of the paper's baseline/proposed pair
    from a :func:`repro_torch.core.systolic.sa_stream_report`."""
    cyc = torch.clamp_min(report["cycles"], 1.0)
    n_pe = report["rows"] * report["cols"]
    pe_slots = report["pe_slots"]
    gated = report["gated_slots"]
    nonzero = report["nonzero_slots"]

    base = price_components(
        em, cyc=cyc, n_pe=n_pe, pe_slots=pe_slots, gated=0.0,
        nonzero=nonzero,
        h_toggles=report["h_reg_toggles_base"],
        v_toggles=report["v_reg_toggles_base"],
        a_toggles=report["mult_a_toggles_base"],
        b_toggles=report["mult_b_toggles_base"],
        a_mant=report["mult_a_mant_toggles_base"],
        b_mant=report["mult_b_mant_toggles"],
        unload_trav=report["unload_reg_traversals"], overhead=0.0)

    overhead = (
        em.E_ZDET * report["zdet_words"]
        + em.E_ENC * report["enc_words"]
        + em.E_DEC_XOR_BIT * em.MANT_FRAC * report["mult_b_toggles_prop"])
    prop = price_components(
        em, cyc=cyc, n_pe=n_pe, pe_slots=pe_slots, gated=gated,
        nonzero=nonzero,
        h_toggles=report["h_reg_toggles_prop"],
        v_toggles=report["v_reg_toggles_prop"],
        a_toggles=report["mult_a_toggles_prop"],
        b_toggles=report["mult_b_toggles_prop"],
        a_mant=report["mult_a_mant_toggles_prop"],
        b_mant=report["mult_b_mant_toggles"],
        unload_trav=report["unload_reg_traversals"], overhead=overhead)

    saving = 1.0 - prop["total"] / torch.clamp_min(base["total"], 1.0)
    stream_saving = 1.0 - prop["streaming"] / torch.clamp_min(
        base["streaming"], 1.0)
    return {
        "baseline": base,
        "proposed": prop,
        "power_base": base["total"] / cyc,
        "power_prop": prop["total"] / cyc,
        "saving_total": saving,
        "saving_streaming": stream_saving,
        "streaming_share_base": base["streaming"] / base["total"],
    }


def aggregate_savings(power_reports: list[dict]) -> dict:
    """Network-level aggregation (energy-weighted, like the paper's overall
    numbers): sums per-layer energies before taking the ratio."""
    tb = sum(float(p["baseline"]["total"]) for p in power_reports)
    tp = sum(float(p["proposed"]["total"]) for p in power_reports)
    sb = sum(float(p["baseline"]["streaming"]) for p in power_reports)
    sp = sum(float(p["proposed"]["streaming"]) for p in power_reports)
    return {
        "total_saving": 1.0 - tp / max(tb, 1.0),
        "streaming_saving": 1.0 - sp / max(sb, 1.0),
        "streaming_share": sb / max(tb, 1.0),
    }
