"""Entry points of the decode-path kernels and of the tile-gated matmul.
``backend`` picks the
implementation as :mod:`repro_torch.kernels.power_counters.ops` does:

* ``"auto"`` (default) -- the Hopper kernel for CUDA tensors, the plain
  PyTorch version for CPU tensors;
* ``"cuda"`` -- the kernel; raises for tensors that are not on the card;
* ``"ref"``  -- the plain version, on whatever device the tensors are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.power_counters.ops import resolve_backend
from repro_torch.kernels.power_counters.spec import CounterSpec

from .kernel import (fused_matmul_counters_cuda, fused_paged_attention_cuda,
                     gated_row_matmul_cuda, zvg_matmul_cuda)
from .ref import (fused_matmul_counters_ref, fused_paged_attention_ref,
                  gated_row_matmul_ref, zvg_matmul_ref)


def gated_row_matmul(x: torch.Tensor, w: torch.Tensor,
                     backend: str | None = None) -> torch.Tensor:
    """ZVG-gated ``x [M, K] @ w [K, N]`` (see :mod:`.ref`)."""
    if resolve_backend(backend, x.device) == "cuda":
        return gated_row_matmul_cuda(x, w)
    return gated_row_matmul_ref(x, w)


def fused_matmul_counters(a: torch.Tensor, w: torch.Tensor,
                          west_spec: CounterSpec, north_spec: CounterSpec,
                          lanes_w: int, cols: int,
                          backend: str | None = None):
    """The gated decode product and its streams' counters in one pass
    (see :func:`.ref.fused_matmul_counters_ref` for the outputs)."""
    if resolve_backend(backend, a.device) == "cuda":
        return fused_matmul_counters_cuda(a, w, west_spec, north_spec,
                                          lanes_w, cols)
    return fused_matmul_counters_ref(a, w, west_spec, north_spec, lanes_w,
                                     cols)


def fused_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, pages: torch.Tensor,
                          lengths: torch.Tensor, attend, *, scale=None,
                          softcap: float = 0.0,
                          backend: str | None = None) -> torch.Tensor:
    """Paged decode attention, ``[B, 1, h, hd]`` in q's dtype: the kernel,
    or the gather and the dense ``attend`` (see
    :func:`.ref.fused_paged_attention_ref`)."""
    if resolve_backend(backend, q.device) == "cuda":
        return fused_paged_attention_cuda(q, k_pool, v_pool, pages, lengths,
                                          scale=scale, softcap=softcap)
    return fused_paged_attention_ref(q, k_pool, v_pool, pages, lengths,
                                     attend, scale=scale, softcap=softcap)


def zvg_matmul(a: torch.Tensor, b: torch.Tensor, block_m: int = 128,
               block_n: int = 128, block_k: int = 128,
               backend: str | None = None):
    """Zero-gated tiled matmul: ``(float32[M, N], gated int32[ceil(M /
    block_m), ceil(K / block_k)])``, the dense product up to the order of
    the float32 sums; a tile of ``a`` holding only zeros (-0.0 included)
    is skipped and marked 1 (see :func:`.ref.zvg_matmul_ref`)."""
    if resolve_backend(backend, a.device) == "cuda":
        return zvg_matmul_cuda(a, b, block_m, block_n, block_k)
    return zvg_matmul_ref(a, b, block_m, block_k)
