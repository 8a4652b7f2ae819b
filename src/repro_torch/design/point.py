"""DesignPoint: a composable spec of one systolic-array design.

The paper's contribution is *selectively targeted* encoding -- BIC on the
weight (North) bus, ZVG on the input (West) bus -- chosen from the
switching statistics of each stream. This module makes that choice a
first-class, composable value instead of a hardwired base/prop dichotomy:

* :class:`Coding` -- what one edge does: nothing, (segmented) bus-invert
  coding, zero-value clock gating, or both stacked (BIC over the
  zero-held stream).
* :class:`DesignPoint` -- per-edge codings + :class:`SAGeometry` +
  :class:`EnergyModel`, frozen and hashable so it can key dicts and ride
  in config dataclasses.

``PAPER_BASELINE`` / ``PAPER_PROPOSED`` are the two fixed designs the
whole stack used to hardwire; every compat shim defaults to exactly this
pair, which is why design-keyed dicts with names ``"baseline"`` /
``"proposed"`` are drop-in compatible with the old twin-field outputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import bic
from repro_torch.core import precision as prec
from repro_torch.core.power import DEFAULT_ENERGY, EnergyModel
from repro_torch.core.systolic import PAPER_SA, SAGeometry


@dataclasses.dataclass(frozen=True)
class Coding:
    """What one bus edge (West inputs / North weights) does.

    ``bic`` is a tuple of disjoint segment masks (``None`` = no BIC);
    ``zvg`` gates zero values. Both together model BIC over the
    zero-held stream plus the is-zero line.
    """
    bic: tuple[int, ...] | None = None
    zvg: bool = False

    def __post_init__(self):
        if self.bic is not None:
            object.__setattr__(self, "bic",
                               tuple(int(s) & 0xFFFF for s in self.bic))
            if not self.bic:
                raise ValueError("bic segments must be non-empty or None")

    @property
    def label(self) -> str:
        parts = []
        if self.bic is not None:
            parts.append("bic(" + "+".join(f"{s:#06x}" for s in self.bic)
                         + ")")
        if self.zvg:
            parts.append("zvg")
        return "+".join(parts) if parts else "none"


NONE = Coding()
ZVG = Coding(zvg=True)


@dataclasses.dataclass(frozen=True)
class ApproxPE:
    """Approximate-multiplier axis of a design point.

    ``mult_discount`` is the fraction of multiplier energy the
    approximate PE saves (applied to ``E_MULT`` only -- the multiplier
    is the sole consumer); ``rel_rms_error`` is the injected
    product-error model, a relative-RMS error per product, which feeds
    the design's accuracy proxy (root-sum-squared with the precision's
    quantization error). Frozen and hashable like everything else in a
    :class:`DesignPoint`.
    """
    mult_discount: float = 0.0
    rel_rms_error: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.mult_discount < 1.0:
            raise ValueError(
                f"mult_discount must be in [0, 1), got {self.mult_discount}")
        if self.rel_rms_error < 0.0:
            raise ValueError(
                f"rel_rms_error must be >= 0, got {self.rel_rms_error}")


def BIC(segments: Sequence[int] = bic.MANTISSA_ONLY, zvg: bool = False
        ) -> Coding:
    """BIC with the given segment masks, optionally stacked with ZVG."""
    return Coding(bic=tuple(int(s) for s in segments), zvg=zvg)


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One fully specified SA design: per-edge codings, geometry, energy.

    ``name`` keys every design-keyed dict in the stack (counters,
    energies, report tables), so it must be unique within an evaluated
    design list.
    """
    name: str
    west: Coding = NONE       # input edge (activations stream here)
    north: Coding = NONE      # weight edge
    geometry: SAGeometry = PAPER_SA
    energy: EnergyModel = DEFAULT_ENERGY
    precision: str = "bf16"   # operand format (repro_torch.core.precision)
    approx: ApproxPE | None = None

    def __post_init__(self):
        if (not self.name or "/" in self.name or "," in self.name
                or any(ch.isspace() or not ch.isprintable()
                       for ch in self.name)):
            raise ValueError(
                f"design name {self.name!r} must be non-empty and free of "
                f"'/', ',', whitespace and control characters (it "
                f"namespaces flat counter keys and rides unquoted through "
                f"CSV rows and CLI lists)")
        prec.get(self.precision)   # fail unknown formats at construction

    def with_(self, **kw) -> "DesignPoint":
        return dataclasses.replace(self, **kw)

    def priced_energy(self) -> EnergyModel:
        """The energy model this design is actually priced with: the
        base model scaled to the design's precision
        (:func:`repro_torch.core.precision.scale_energy` -- the IDENTITY
        object for bf16), with the approximate-PE multiplier discount
        applied on top. ``E_MULT`` is the only constant the discount
        touches, so an approximate design differs from its exact twin
        in the ``mult`` component alone."""
        em = prec.scale_energy(self.energy, self.precision)
        if self.approx is not None and self.approx.mult_discount:
            em = dataclasses.replace(
                em, E_MULT=em.E_MULT * (1.0 - self.approx.mult_discount))
        return em

    @property
    def accuracy_proxy(self) -> float:
        """Relative-RMS numerical error proxy of this design: the
        precision's quantization error and the approximate-PE product
        error, root-sum-squared (independent error sources). 0.0 for
        exact bf16 -- the accuracy reference."""
        q = prec.get(self.precision).quant_rms
        a = self.approx.rel_rms_error if self.approx is not None else 0.0
        return math.sqrt(q * q + a * a)

    @property
    def label(self) -> str:
        g = self.geometry
        extra = "" if self.precision == "bf16" else f" {self.precision}"
        if self.approx is not None and self.approx.mult_discount:
            extra += f" ~ax{self.approx.mult_discount:.2f}"
        return (f"{self.name}[west={self.west.label} "
                f"north={self.north.label} {g.rows}x{g.cols}{extra}]")


#: The paper's two fixed designs (16x16, default energy model).
PAPER_BASELINE = DesignPoint("baseline")
PAPER_PROPOSED = DesignPoint("proposed", west=ZVG, north=BIC())
PAPER_PAIR = (PAPER_BASELINE, PAPER_PROPOSED)


def paper_pair(geometry: SAGeometry = PAPER_SA,
               bic_segments: Sequence[int] = bic.MANTISSA_ONLY,
               zvg: bool = True,
               energy: EnergyModel = DEFAULT_ENERGY
               ) -> tuple[DesignPoint, DesignPoint]:
    """The baseline/proposed pair for arbitrary knobs -- the design-list
    equivalent of the old ``sa_stream_report(geom, segments, zvg)``
    argument triple, used by every compat shim."""
    return (DesignPoint("baseline", geometry=geometry, energy=energy),
            DesignPoint("proposed",
                        west=ZVG if zvg else NONE,
                        north=BIC(bic_segments),
                        geometry=geometry, energy=energy))


def named_designs(geometry: SAGeometry = PAPER_SA,
                  energy: EnergyModel = DEFAULT_ENERGY
                  ) -> dict[str, DesignPoint]:
    """The standard design menu (CLI ``--designs`` names, selection
    candidates). All entries share ``geometry``/``energy`` so one stream
    pass prices the whole menu."""
    mk = lambda name, west, north: DesignPoint(
        name, west=west, north=north, geometry=geometry, energy=energy)
    return {
        "baseline": mk("baseline", NONE, NONE),
        "proposed": mk("proposed", ZVG, BIC()),
        "bic-only": mk("bic-only", NONE, BIC()),
        "zvg-only": mk("zvg-only", ZVG, NONE),
        "bic-west": mk("bic-west", BIC(zvg=True), BIC()),
        "mant-exp": mk("mant-exp", ZVG, BIC(bic.MANT_EXP)),
        "full-bus": mk("full-bus", ZVG, BIC(bic.FULL_BUS)),
    }


def resolve_designs(names: Sequence[str],
                    geometry: SAGeometry = PAPER_SA,
                    energy: EnergyModel = DEFAULT_ENERGY
                    ) -> tuple[DesignPoint, ...]:
    """Look up a list of design names in :func:`named_designs`.

    Duplicate names are rejected: every counter/energy dict downstream
    is keyed by design name, so a repeated name would silently collapse
    two entries into one (the documented-but-previously-unenforced
    uniqueness contract of :class:`DesignPoint.name`).
    """
    names = list(names)
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(
            f"duplicate design name(s) {dupes}: design names key every "
            f"counter/energy dict in the stack, so duplicates would "
            f"silently overwrite each other")
    menu = named_designs(geometry, energy)
    bad = [n for n in names if n not in menu]
    if bad:
        raise ValueError(
            f"unknown design name(s) {bad}; choose from {sorted(menu)}")
    return tuple(menu[n] for n in names)
