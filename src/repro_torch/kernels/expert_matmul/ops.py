"""Entry point of K8. ``backend`` picks the implementation as
:mod:`repro_torch.kernels.power_counters.ops` does: ``"auto"`` (or
``None``) the Hopper kernel for CUDA tensors, raising for operands it
does not take (:func:`.kernel.expert_route`), the plain version for CPU
tensors; ``"cuda"`` the kernel; ``"ref"`` the plain version on any
device."""
from __future__ import annotations

import torch

from repro_torch.kernels.power_counters.ops import resolve_backend

from .kernel import expert_matmul_cuda
from .ref import expert_matmul_ref


def expert_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                  rows_max: int, w_up: torch.Tensor | None = None,
                  act=None, silu: bool = False,
                  backend: str | None = None) -> torch.Tensor:
    """Each expert's segment of the sorted rows ``x [P, K]`` times its
    weights ``w [E, K, N]`` (with ``w_up``: ``act(x_e @ w[e]) * (x_e @
    w_up[e])``), see :mod:`.ref`. ``rows_max`` bounds the rows of every
    segment. The kernel computes SiLU as its gate's activation: a gated
    call takes it only where ``silu`` says ``act`` is SiLU, and raises
    otherwise."""
    if resolve_backend(backend, x.device) == "cuda":
        if w_up is not None and not silu:
            raise ValueError("K8's gated product computes SiLU only")
        return expert_matmul_cuda(x, w, offsets, rows_max, w_up)
    return expert_matmul_ref(x, w, offsets, w_up, act)
