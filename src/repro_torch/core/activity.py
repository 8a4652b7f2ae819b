"""Switching-activity accounting for streamed matrices.

In a skewed, pipelined SA every register on a stream's path sees the same
value sequence (delayed), so the register toggles of a pipeline equal
(per-stream transitions) x (registers on the path): per-stream counts are
all the power model needs.
"""
from __future__ import annotations

import torch

from . import bits as B


def stream_transitions(stream: torch.Tensor, mask: int = 0xFFFF,
                       init: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lane bit-transition counts of an (unencoded) word stream.

    Args:
      stream: words ``[T, *lanes]``.
      mask: restrict counting to these bus bits.
      init: initial bus state (default zeros); the init->first edge counts.
    Returns:
      ``int32[*lanes]``.
    """
    stream = stream.to(torch.int32)
    if init is None:
        init = torch.zeros_like(stream[0])
    prev = torch.cat([init.to(torch.int32)[None], stream[:-1]], dim=0)
    return B.hamming(stream, prev, mask).sum(dim=0, dtype=torch.int32)


def matrix_stream_bits(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Words of a matrix with the streaming axis moved to the front
    (contiguous, so each cycle's lanes are adjacent in memory)."""
    return B.to_bits(x).movedim(axis, 0).contiguous()
