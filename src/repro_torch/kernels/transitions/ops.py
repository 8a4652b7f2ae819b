"""Public entry of the stream-transition counter. ``backend`` picks the
implementation as :mod:`repro_torch.kernels.power_counters.ops` does:
``"auto"`` (default) the Hopper kernel for a CUDA tensor and the plain
version for a CPU tensor, ``"cuda"`` the kernel (raises off the card),
``"ref"`` the plain version on whatever device the tensor is."""
from __future__ import annotations

import torch

from repro_torch.kernels.power_counters.ops import resolve_backend

from .kernel import transitions_cuda
from .ref import transitions_ref


def count_transitions(x: torch.Tensor, mask: int = 0xFFFF,
                      init: torch.Tensor | None = None,
                      backend: str | None = None) -> torch.Tensor:
    """Per-lane transition counts ``int32[L]`` of words ``[T, L]``
    (``uint16``, or ``int32`` holding 0..65535) under ``mask``, from the
    bus state ``init`` (default zeros)."""
    if resolve_backend(backend, x.device) == "cuda":
        return transitions_cuda(x, mask, init)
    return transitions_ref(x, mask, init)
