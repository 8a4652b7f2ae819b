"""Plain PyTorch version of the single-segment BIC encoder (K6): the
port's serial encoder :func:`repro_torch.core.bic.bic_encode` with one
segment, as the JAX package's ``bic_encode/ref.py`` delegates to its own.
"""
from __future__ import annotations

import torch

from repro_torch.core import bic
from repro_torch.kernels.transitions.ref import check_words


def check_mask(mask: int) -> int:
    """The segment mask as an int; raises unless it is a 16-bit word with
    at least one bit set."""
    mask = int(mask)
    if not 0 < mask <= 0xFFFF:
        raise ValueError(f"the segment mask must be a 16-bit word other "
                         f"than 0, got {mask:#x}")
    return mask


def bic_encode_ref(x: torch.Tensor, mask: int):
    """Encode words ``[T, L]`` with single-segment BIC from a bus idling
    at 0. Returns ``(tx, inv)``: ``tx`` in ``x``'s word dtype and ``inv
    bool[T, L]``."""
    mask = check_mask(mask)
    check_words(x)
    tx, inv = bic.bic_encode(x, (mask,))
    return tx.to(x.dtype), inv[:, 0]
