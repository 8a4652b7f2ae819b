"""Bit-level utilities for bfloat16 bus words.

Bfloat16 layout (MSB..LSB):  [sign:1][exponent:8][mantissa:7]
  bit index:                  15     14..7        6..0

Words are ``int32`` tensors holding 0..65535 (see the package docstring):
every stream function of :mod:`repro_torch.core` takes them as produced
by :func:`to_bits`.
"""
from __future__ import annotations

import torch

SIGN_SHIFT = 15
EXP_MASK = 0x7F80
MANT_MASK = 0x007F

#: the quiet-NaN word XLA writes for a NaN cast to bfloat16 (sign kept)
QNAN = 0x7FC0


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` to bfloat16 (nearest-even) and return its words as
    ``int32`` in 0..65535, same shape and device.

    A bfloat16 input is bitcast as it is. Where the cast happens, every
    NaN becomes ``0x7FC0 | sign << 15``, the word XLA's cast writes:
    PyTorch's own cast gives ``0xFFFF`` for every NaN on the CPU, whatever
    its sign, and the CUDA cast need not agree with either.
    """
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    words = x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    if not x.is_floating_point():
        return words
    sign = torch.signbit(x).to(torch.int32)
    return torch.where(torch.isnan(x), QNAN | (sign << SIGN_SHIFT), words)


def from_bits(u: torch.Tensor) -> torch.Tensor:
    """Words (any integer dtype, 0..65535) back to bfloat16."""
    return u.to(torch.int32).to(torch.int16).view(torch.bfloat16)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """Cast to bfloat16 with XLA's NaN words (see :func:`to_bits`)."""
    return from_bits(to_bits(x))


def popcount(u: torch.Tensor) -> torch.Tensor:
    """Per-element population count of 16-bit words held in ``int32``
    (SWAR: pairs, nibbles, bytes; no intermediate leaves 16 bits)."""
    v = u & 0xFFFF
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def hamming(a: torch.Tensor, b: torch.Tensor, mask: int = 0xFFFF
            ) -> torch.Tensor:
    """Per-element Hamming distance between two word tensors under
    ``mask``."""
    return popcount((a ^ b) & mask)


def segment_width(mask: int) -> int:
    """Number of bits selected by a segment mask (static python int)."""
    return int(bin(int(mask) & 0xFFFF).count("1"))
