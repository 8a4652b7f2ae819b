"""Arithmetic precision formats for the design space.

Every format's words are *embedded* into the 16-bit bus layout the
counter pass counts, placed so its field masks keep their meaning:

* ``bf16``     -- the native layout (``[sign:15][exp:14..7][mant:6..0]``).
* ``fp8e4m3``  -- sign -> bit 15, the 4 exponent bits -> 10..7, the 3
  mantissa bits -> 2..0; ``word & 0x7FFF`` still detects +-0.0.
* ``int8``     -- the two's-complement byte in the low 8 bits, from
  per-tensor symmetric absmax quantization to ``[-127, 127]``.

:func:`scale_energy` derives a precision-scaled
:class:`~repro_torch.core.power.EnergyModel`; for ``bf16`` it returns the
input model unchanged, so bf16 pricing is untouched by the precision
axis.
"""
from __future__ import annotations

import dataclasses

import torch

from . import bits as B
from .power import EnergyModel


@dataclasses.dataclass(frozen=True)
class Precision:
    """One arithmetic format, as seen by the 16-bit counter pass.

    ``segments`` maps the coding-scheme names to BIC segment masks in the
    EMBEDDED layout; ``quant_rms`` is the relative-RMS quantization error
    proxy; the scales multiply the bf16 multiplier and adder energies.
    """
    name: str
    bits: int             # physical bus width
    mant_bits: int        # mantissa / magnitude field width
    segments: dict[str, tuple[int, ...]]
    quant_rms: float      # relative-RMS quantization error proxy
    mult_scale: float     # E_MULT scale vs the bf16 multiplier
    add_scale: float      # E_ADD scale (accumulation stays 32-bit)


PRECISIONS: dict[str, Precision] = {
    "bf16": Precision(
        name="bf16", bits=16, mant_bits=7,
        segments={"mantissa": (0x007F,),
                  "mant_exp": (0x007F, 0x7F80),
                  "full": (0xFFFF,)},
        quant_rms=0.0,
        mult_scale=1.0, add_scale=1.0),
    "fp8e4m3": Precision(
        name="fp8e4m3", bits=8, mant_bits=3,
        segments={"mantissa": (0x0007,),
                  "mant_exp": (0x0007, 0x0780),
                  "full": (0x8787,)},
        quant_rms=2.0 ** -3 / (2.0 * 3.0 ** 0.5),
        mult_scale=0.25, add_scale=0.6),
    "int8": Precision(
        name="int8", bits=8, mant_bits=7,
        segments={"mantissa": (0x007F,),
                  "full": (0x00FF,)},
        quant_rms=4.0 / 127.0 / (2.0 * 3.0 ** 0.5),
        mult_scale=0.20, add_scale=0.45),
}


def get(name: str) -> Precision:
    if name not in PRECISIONS:
        raise ValueError(
            f"unknown precision {name!r}; choose from {sorted(PRECISIONS)}")
    return PRECISIONS[name]


def _fp8e4m3_bits(x: torch.Tensor) -> torch.Tensor:
    """fp8-e4m3 round + embed. The input is clamped to the format's +-448
    first, so no overflow reaches the cast."""
    f = torch.clamp(x.to(torch.float32), -448.0, 448.0)
    b = f.to(torch.float8_e4m3fn).view(torch.uint8).to(torch.int32)
    sign = (b >> 7) & 0x1
    exp = (b >> 3) & 0xF
    mant = b & 0x7
    return (sign << 15) | (exp << 7) | mant


def _int8_bits(x: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """Per-tensor symmetric absmax int8 quantization, low-byte embed (one
    scale per problem of the leading ``batch_dims``)."""
    f = x.to(torch.float32)
    absmax = torch.abs(f).amax(dim=tuple(range(batch_dims, f.dim())),
                               keepdim=True)
    scale = torch.where(absmax > 0.0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(f / scale), -127.0, 127.0).to(torch.int8)
    return q.view(torch.uint8).to(torch.int32)


def quantize_bits(x: torch.Tensor, precision: str | Precision,
                  batch_dims: int = 0) -> torch.Tensor:
    """Quantize ``x`` to the format and return the embedded bus words
    (``int32``, same shape). ``bf16`` is exactly
    :func:`repro_torch.core.bits.to_bits`. The leading ``batch_dims``
    index independent problems (int8 takes one scale per problem)."""
    name = precision.name if isinstance(precision, Precision) else precision
    if name == "bf16":
        return B.to_bits(x)
    if name == "fp8e4m3":
        return _fp8e4m3_bits(x)
    if name == "int8":
        return _int8_bits(x, batch_dims)
    raise ValueError(
        f"unknown precision {name!r}; choose from {sorted(PRECISIONS)}")


def scale_energy(em: EnergyModel, precision: str | Precision) -> EnergyModel:
    """Precision-scaled :class:`EnergyModel` (the input object itself for
    ``bf16``): narrower multiplier/adder energies, 8 fewer flop-bits per
    operand register, half-width detectors and encoders, and the
    format's field widths as the multiplier model's normalisers."""
    p = precision if isinstance(precision, Precision) else get(precision)
    if p.name == "bf16":
        return em
    shrink = float(16 - p.bits)            # per-operand register bits saved
    return dataclasses.replace(
        em,
        E_MULT=em.E_MULT * p.mult_scale,
        E_ADD=em.E_ADD * p.add_scale,
        REG_BITS_PER_PE=em.REG_BITS_PER_PE - 2.0 * shrink,
        GATEABLE_BITS_PER_PE=em.GATEABLE_BITS_PER_PE - shrink,
        E_ZDET=em.E_ZDET * p.bits / 16.0,
        E_ENC=em.E_ENC * p.bits / 16.0,
        MANT_FRAC=p.mant_bits / p.bits,
        MANT_BITS=float(p.mant_bits),
        BUS_BITS=float(p.bits))
