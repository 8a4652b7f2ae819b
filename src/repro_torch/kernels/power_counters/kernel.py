"""Wrapper of the Hopper power-counter kernel (``csrc/power_counters.cu``).

The kernel replaces the TPU kernel
``repro/kernels/power_counters/kernel.py::fused_counters_pallas``; the
source's header says how, and what bounds it. It is built with ``nvcc``
at first use and called through ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

from .spec import CounterSpec

_WORD_BYTES = {torch.uint16: 2, torch.int32: 4}


@functools.cache
def _function():
    fn = _build.load("power_counters").pc_fused_counters
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_counters_cuda(x: torch.Tensor, spec: CounterSpec):
    """Run the fused counter pass on the card over words ``[T, L]`` or
    ``[B, T, L]`` (``uint16``, or ``int32`` holding 0..65535, contiguous).

    Returns ``(counts: int32[(B,) n_rows, L], rowzeros: int32[(B,) T])``,
    bit-identical to :func:`.ref.fused_counters_ref`. Raises on a tensor
    the kernel does not take; never falls back to the plain version.
    """
    if x.device.type != "cuda":
        raise ValueError(f"fused_counters_cuda needs a CUDA tensor, got "
                         f"one on {x.device}")
    if x.dtype not in _WORD_BYTES:
        raise TypeError(f"words must be uint16 or int32, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"words must be [T, L] or [B, T, L], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("words must be contiguous")
    batched = x.dim() == 3
    x3 = x if batched else x[None]
    B, T, L = x3.shape
    if not (1 <= B <= 65535 and T >= 1 and L >= 1):
        raise ValueError(f"unsupported stream shape {tuple(x.shape)}")
    segs = spec.unique_segments
    if len(spec.bic_variants) > 64:
        raise ValueError(f"{len(spec.bic_variants)} BIC variants exceed "
                         f"the kernel's 64")
    variant_segs = [sum(1 << segs.index(m) for m in v)
                    for v in spec.bic_variants]
    counts = torch.empty((B, spec.n_rows, L), dtype=torch.int32,
                         device=x.device)
    rowzeros = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _function()(
            x3.data_ptr(), _WORD_BYTES[x.dtype], B, T, L,
            counts.data_ptr(), rowzeros.data_ptr(), spec.n_rows,
            len(segs), (ctypes.c_uint32 * max(len(segs), 1))(*segs),
            len(variant_segs),
            (ctypes.c_uint32 * max(len(variant_segs), 1))(*variant_segs),
            int(spec.zvg), int(spec.hist), stream)
    if err:
        raise RuntimeError(f"power_counters kernel launch failed: CUDA "
                           f"error {err}")
    fused_counters_cuda.launches += 1
    if batched:
        return counts, rowzeros
    return counts[0], rowzeros[0]


#: kernel launches so far; set it to 0 before a run to count that run's
fused_counters_cuda.launches = 0
