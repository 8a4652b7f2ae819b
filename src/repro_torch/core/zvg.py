"""Zero-Value clock Gating (ZVG) stream accounting.

When an input value is zero, the proposed SA freezes the horizontal
pipeline register, raises an ``is-zero`` line that travels with the
bubble, and data-gates every PE the bubble reaches. So the gated
register's toggle sequence is the *zero-compressed* stream, and the
1-bit ``is-zero`` line toggles at zero-run boundaries.

Zero detection treats +0.0 and -0.0 as zero (``word & 0x7FFF == 0``).
"""
from __future__ import annotations

import torch

from . import bits as B

NOT_SIGN = 0x7FFF


def is_zero(bits: torch.Tensor) -> torch.Tensor:
    """Per-word zero flag (ignores the sign bit, so -0.0 counts as zero)."""
    return (bits & NOT_SIGN) == 0


def zvg_stream_report(stream: torch.Tensor,
                      init: torch.Tensor | None = None) -> dict:
    """Activity accounting of a zero-gated input stream.

    Args:
      stream: words ``[T, *lanes]`` of a bf16 input stream.
      init: initial register state (default zeros).

    Returns a dict of per-lane ``int32[*lanes]`` counters:
      ``transitions``        register/wire bit toggles with gating applied
      ``transitions_raw``    toggles of the ungated stream (baseline design)
      ``transitions_mant``   mantissa-field-only gated toggles
      ``transitions_mant_raw``  ungated mantissa-field toggles
      ``iszero_toggles``     toggles of the 1-bit is-zero line
      ``zeros``              gated (skipped) cycle count
    """
    stream = stream.to(torch.int32)
    init = (torch.zeros_like(stream[0]) if init is None
            else init.to(torch.int32))
    z = is_zero(stream)
    held = zero_held_stream(stream, init)
    prev_held = torch.cat([init[None], held[:-1]], dim=0)
    prev_raw = torch.cat([init[None], stream[:-1]], dim=0)
    prev_z = torch.cat([torch.zeros_like(z[:1]), z[:-1]], dim=0)

    def total(v):
        return v.sum(dim=0, dtype=torch.int32)

    return {
        "transitions": total(B.hamming(held, prev_held)),
        "transitions_raw": total(B.hamming(stream, prev_raw)),
        "transitions_mant": total(B.hamming(held, prev_held, B.MANT_MASK)),
        "transitions_mant_raw": total(B.hamming(stream, prev_raw,
                                                B.MANT_MASK)),
        "iszero_toggles": total(z ^ prev_z),
        "zeros": total(z),
    }


def zero_held_stream(stream: torch.Tensor,
                     init: torch.Tensor | None = None) -> torch.Tensor:
    """The effective register sequence under ZVG: each zero word is
    replaced by the last transmitted non-zero value (``init`` before the
    first one). The serial reference: one step per cycle, vectorised
    over lanes."""
    stream = stream.to(torch.int32)
    held = (torch.zeros_like(stream[0]) if init is None
            else init.to(torch.int32))
    out = []
    for x in stream:
        held = torch.where(is_zero(x), held, x)
        out.append(held)
    return torch.stack(out, dim=0) if out else stream


def zero_fraction(x: torch.Tensor) -> torch.Tensor:
    """Fraction of exactly-zero elements of a (bf16-castable) tensor, as
    a float32 0-d tensor."""
    return is_zero(B.to_bits(x)).to(torch.float32).mean()
