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

NOT_SIGN = 0x7FFF


def is_zero(bits: torch.Tensor) -> torch.Tensor:
    """Per-word zero flag (ignores the sign bit, so -0.0 counts as zero)."""
    return (bits & NOT_SIGN) == 0


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
