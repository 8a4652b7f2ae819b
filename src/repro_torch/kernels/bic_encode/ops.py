"""Public entry of the single-segment BIC encoder. ``backend`` picks the
implementation as :mod:`repro_torch.kernels.power_counters.ops` does:
``"auto"`` (default) the Hopper kernel for a CUDA tensor and the plain
version for a CPU tensor, ``"cuda"`` the kernel (raises off the card),
``"ref"`` the plain version on whatever device the tensor is."""
from __future__ import annotations

import torch

from repro_torch.core.bits import MANT_MASK
from repro_torch.kernels.power_counters.ops import resolve_backend

from .kernel import bic_encode_cuda
from .ref import bic_encode_ref, check_mask


def bic_encode(x: torch.Tensor, mask: int = MANT_MASK,
               backend: str | None = None):
    """Single-segment BIC encode of words ``[T, L]`` (``uint16``, or
    ``int32`` holding 0..65535) from a bus idling at 0.

    Returns ``(tx, inv)``: the transmitted words in ``x``'s dtype and the
    invert line ``bool[T, L]``. The default mask is the paper's
    configuration (the bf16 mantissa field); a mask of 0 or wider than 16
    bits raises on both backends.
    """
    mask = check_mask(mask)
    if resolve_backend(backend, x.device) == "cuda":
        return bic_encode_cuda(x, mask)
    return bic_encode_ref(x, mask)
