"""Public entry of the fused power-counter pass.

``edge_counters`` is the one entry point the rest of the port uses
(:func:`repro_torch.core.systolic.sa_design_report` calls it once per
operand edge). ``backend`` picks the implementation:

* ``"auto"`` (default) -- the Hopper kernel for a CUDA tensor, the plain
  PyTorch version for a CPU tensor;
* ``"cuda"`` -- the kernel; raises for a tensor that is not on the card;
* ``"ref"``  -- the plain version, on whatever device the tensor is.

There is no environment override: the main path on the card always runs
the kernel.
"""
from __future__ import annotations

import torch

from .kernel import fused_counters_cuda
from .ref import fused_counters_ref
from .spec import CounterSpec

BACKENDS = ("auto", "cuda", "ref")


def resolve_backend(backend: str | None, device: torch.device) -> str:
    """Normalize a backend name to ``"cuda"`` or ``"ref"`` for tensors on
    ``device``."""
    backend = backend or "auto"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown counter backend {backend!r}; choose from {BACKENDS}")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "ref"
    return backend


def edge_counters(bits: torch.Tensor, spec: CounterSpec,
                  backend: str | None = None) -> dict:
    """Fused counter pass over one edge stream ``[T, L]`` (or a batch
    ``[B, T, L]``) of words.

    Returns ``{row_name: int32[(B,) L]}`` for every row of ``spec.rows``
    plus ``"rowzeros": int32[(B,) T]``, the per-cycle zero words.
    """
    if resolve_backend(backend, bits.device) == "cuda":
        counts, rowzeros = fused_counters_cuda(bits, spec)
    else:
        counts, rowzeros = fused_counters_ref(bits, spec)
    out = {name: counts[..., i, :] for i, name in enumerate(spec.rows)}
    out["rowzeros"] = rowzeros
    return out
