"""Bus-Invert Coding (BIC) over streaming buses.

Stan/Burleson bus-invert coding and its segmented variant, as the paper
uses it: each bus *segment* (e.g. the bf16 mantissa field) is encoded
independently. The encoder compares the incoming word with the
*currently transmitted* (encoded) bus value; if the Hamming distance
inside a segment exceeds half the segment width, that segment is sent
inverted and the segment's ``inv`` line is raised.

Conventions (the same as the JAX reference):

* streams are word tensors ``[T, *lanes]`` (T = cycles), from
  :func:`repro_torch.core.bits.to_bits`;
* the bus starts at ``init`` (default zeros) with every ``inv`` line low,
  and the ``init -> tx[0]`` edge counts as a transition;
* ties (distance == width/2) are NOT inverted.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import bits as B

Segments = Sequence[int]

#: The paper's selected configuration: BIC on the weight mantissa field only.
MANTISSA_ONLY: tuple[int, ...] = (B.MANT_MASK,)
FULL_BUS: tuple[int, ...] = (0xFFFF,)
EXPONENT_ONLY: tuple[int, ...] = (B.EXP_MASK,)
#: Segmented BIC over {mantissa, exponent} independently.
MANT_EXP: tuple[int, ...] = (B.MANT_MASK, B.EXP_MASK)

#: Canonical CLI/sweep names for the segment variants above.
NAMED_SEGMENTS: dict[str, tuple[int, ...]] = {
    "mantissa": MANTISSA_ONLY,
    "mant+exp": MANT_EXP,
    "full": FULL_BUS,
    "exponent": EXPONENT_ONLY,
}


def seg_key(segments: Segments) -> str:
    """Canonical menu-key suffix for a BIC segment tuple (the counter
    rows and the SA menu are both keyed with it)."""
    return "+".join(f"{int(s) & 0xFFFF:04x}" for s in segments)


def _check_segments(segments: Segments) -> tuple[int, ...]:
    segs = tuple(int(s) & 0xFFFF for s in segments)
    if not segs:
        raise ValueError("need at least one segment mask")
    for i, a in enumerate(segs):
        if a == 0:
            raise ValueError("empty segment mask")
        for b in segs[i + 1:]:
            if a & b:
                raise ValueError(f"overlapping segment masks {a:#x} and {b:#x}")
    return segs


def bic_encode(stream: torch.Tensor, segments: Segments = MANTISSA_ONLY,
               init: torch.Tensor | None = None):
    """Encode a word stream with (segmented) bus-invert coding.

    The serial reference: one step per cycle, vectorised over lanes.

    Args:
      stream: words ``[T, *lanes]`` in transmission order.
      segments: disjoint bit masks; each is encoded independently.
      init: initial bus state ``[*lanes]`` (default zeros).

    Returns:
      ``(tx, inv)``: the encoded ``int32[T, *lanes]`` stream (bits outside
      every segment pass through) and ``bool[T, S, *lanes]``, one invert
      line per segment.
    """
    segs = _check_segments(segments)
    stream = stream.to(torch.int32)
    prev_tx = (torch.zeros_like(stream[0]) if init is None
               else init.to(torch.int32))
    txs, invs = [], []
    for x in stream:
        tx = x
        inv_t = []
        for m in segs:
            inv = B.hamming(x, prev_tx, m) * 2 > B.segment_width(m)
            tx = torch.where(inv, tx ^ m, tx)
            inv_t.append(inv)
        prev_tx = tx
        txs.append(tx)
        invs.append(torch.stack(inv_t, dim=0))
    if not txs:
        return stream, torch.zeros((0, len(segs)) + stream.shape[1:],
                                   dtype=torch.bool, device=stream.device)
    return torch.stack(txs, dim=0), torch.stack(invs, dim=0)


def bic_decode(tx: torch.Tensor, inv: torch.Tensor,
               segments: Segments = MANTISSA_ONLY) -> torch.Tensor:
    """Invert :func:`bic_encode`: the original ``int32[T, *lanes]``
    stream from the transmitted words and ``inv bool[T, S, *lanes]``."""
    segs = _check_segments(segments)
    out = tx.to(torch.int32)
    for si, m in enumerate(segs):
        out = torch.where(inv[:, si], out ^ m, out)
    return out


def bic_transitions(stream: torch.Tensor,
                    segments: Segments = MANTISSA_ONLY,
                    init: torch.Tensor | None = None,
                    include_inv_lines: bool = True) -> torch.Tensor:
    """Per-lane bus transition counts after BIC encoding: toggles of every
    data bit of the encoded bus plus (optionally) of the per-segment
    ``inv`` lines, the ``init -> tx[0]`` edge included.

    Returns ``int32[*lanes]``.
    """
    segs = _check_segments(segments)
    stream = stream.to(torch.int32)
    init = (torch.zeros_like(stream[0]) if init is None
            else init.to(torch.int32))
    tx, inv = bic_encode(stream, segs, init)
    prev = torch.cat([init[None], tx[:-1]], dim=0)
    data_t = B.hamming(tx, prev).sum(dim=0, dtype=torch.int32)
    if not include_inv_lines:
        return data_t
    prev_inv = torch.cat([torch.zeros_like(inv[:1]), inv[:-1]], dim=0)
    return data_t + (inv ^ prev_inv).sum(dim=(0, 1), dtype=torch.int32)


def encode_weight_mantissas(w: torch.Tensor):
    """Paper configuration: BIC-encode the mantissa field of bf16 weights
    ``[K, N]`` in streaming order (K = streaming axis).

    Returns ``(tx_bits int32[K, N], inv bool[K, 1, N])``.
    """
    return bic_encode(B.to_bits(w), MANTISSA_ONLY)
