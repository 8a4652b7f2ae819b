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


def matrix_transitions(x: torch.Tensor, axis: int,
                       mask: int = 0xFFFF) -> torch.Tensor:
    """Total transitions (``int32`` 0-d) when streaming matrix ``x`` along
    ``axis``: weights ``[K, N]`` stream along ``axis=0``, each of the N
    columns a lane and K the time."""
    return stream_transitions(matrix_stream_bits(x, axis), mask).sum(
        dtype=torch.int32)


def activity_factor(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Mean per-bit toggle probability of the stream (0..1), float32."""
    bits = matrix_stream_bits(x, axis)
    t = stream_transitions(bits).sum(dtype=torch.int32)
    return t.to(torch.float32) / (bits.numel() * B.BF16_BITS)


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors, rounded to float32 once (a fused
    multiply-add): the product is exact in float64, the sum is rounded to
    odd there (its TwoSum error decides), so the one rounding to float32
    is the correctly rounded one."""
    a, b, c = (t.to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _linspace_f32(start: torch.Tensor, stop: torch.Tensor,
                  num: int) -> torch.Tensor:
    """``num`` float32 points from ``start`` to ``stop`` as XLA compiles
    the JAX package's ``linspace`` (``start * (1 - s) + stop * s``, ``s =
    i / (num - 1)``) on the CPU: the division becomes a product with the
    float32 reciprocal, ``stop * s`` is reassociated into ``i * (stop *
    r)`` and fused with the sum into one multiply-add; ``stop`` itself
    last."""
    div = num - 1
    rcp = torch.tensor(1.0 / div, dtype=torch.float32, device=start.device)
    i = torch.arange(div, dtype=torch.float32, device=start.device)
    out = _fma_f32(i, stop * rcp, start * (1 - i * rcp))
    return torch.cat([out, stop[None]])


def _histogram(v: torch.Tensor, bins: int):
    """Counts (float32) and edges of ``bins`` equal bins over the range of
    ``v`` (float32, flat), with ``jnp.histogram``'s rules: bins closed on
    the left, the last also on the right, and a range of zero width
    widened by 0.5 each way."""
    lo, hi = v.min(), v.max()
    if bool(lo == hi):
        lo, hi = lo - 0.5, hi + 0.5
    edges = _linspace_f32(lo, hi, bins + 1)
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 1)[1:bins + 1]
    return counts.to(torch.float32), edges


def field_histograms(w: torch.Tensor, bins: int = 64) -> dict:
    """Value/exponent/mantissa histograms of a weight tensor (paper
    Fig. 2): ``value_counts`` (float32) and ``value_edges`` over the
    float32 values, and ``exp_counts`` / ``mant_counts`` (int32) over the
    raw field values (256 / 128 buckets)."""
    words = B.to_bits(w).reshape(-1)
    val_counts, val_edges = _histogram(w.to(torch.float32).reshape(-1),
                                       bins)
    return {
        "value_counts": val_counts,
        "value_edges": val_edges,
        "exp_counts": torch.bincount(B.exponent_field(words),
                                     minlength=256).to(torch.int32),
        "mant_counts": torch.bincount(B.mantissa_field(words),
                                      minlength=128).to(torch.int32),
    }


def concentration(counts: torch.Tensor, top: int = 8) -> torch.Tensor:
    """Fraction of the mass in the ``top`` most frequent buckets (float32
    0-d): exponents are concentrated (high), mantissas near-uniform
    (low), the paper's Fig. 2 claim."""
    c = counts.to(torch.float32)
    total = torch.clamp_min(c.sum(), 1.0)
    return torch.sort(c, descending=True).values[:top].sum() / total
