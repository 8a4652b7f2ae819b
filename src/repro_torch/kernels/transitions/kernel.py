"""Wrapper of the Hopper transition counter (``csrc/transitions.cu``).

The kernel replaces the TPU kernel
``repro/kernels/transitions/kernel.py::transitions_pallas``; the source's
header says how, and what bounds it. It is built with ``nvcc`` at first
use and called through ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

from .ref import WORD_BYTES, check_words


@functools.cache
def _function():
    fn = _build.load("transitions").tr_count_transitions
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def transitions_cuda(x: torch.Tensor, mask: int = 0xFFFF,
                     init: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lane transition counts ``int32[L]`` of contiguous words ``[T,
    L]`` on the card, bit for bit :func:`.ref.transitions_ref`. Raises on
    a tensor the kernel does not take; never falls back to the plain
    version."""
    if x.device.type != "cuda":
        raise ValueError(f"transitions_cuda needs a CUDA tensor, got one "
                         f"on {x.device}")
    check_words(x, init)
    if not x.is_contiguous():
        raise ValueError("words must be contiguous")
    T, L = x.shape
    if init is not None:
        init = init.to(torch.int32).contiguous()
    out = torch.zeros(L, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _function()(
            x.data_ptr(), WORD_BYTES[x.dtype],
            None if init is None else init.data_ptr(), T, L,
            int(mask) & 0xFFFF, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"transitions kernel launch failed: CUDA error "
                           f"{err}")
    transitions_cuda.launches += 1
    return out


#: kernel launches so far; set it to 0 before a run to count that run's
transitions_cuda.launches = 0
