"""Wrapper of the Hopper BIC encoder (``csrc/bic_encode.cu``).

The kernel replaces the TPU kernel
``repro/kernels/bic_encode/kernel.py::bic_encode_pallas``; the source's
header says how, and what bounds it. It is built with ``nvcc`` at first
use and called through ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.transitions.ref import WORD_BYTES, check_words

from .ref import check_mask


@functools.cache
def _function():
    fn = _build.load("bic_encode").be_bic_encode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bic_encode_cuda(x: torch.Tensor, mask: int):
    """Single-segment BIC encode of contiguous words ``[T, L]`` on the
    card: ``(tx, inv)``, ``tx`` in ``x``'s word dtype and ``inv bool[T,
    L]``, bit for bit :func:`.ref.bic_encode_ref`. Raises on a tensor or
    mask the kernel does not take; never falls back to the plain
    version."""
    mask = check_mask(mask)
    if x.device.type != "cuda":
        raise ValueError(f"bic_encode_cuda needs a CUDA tensor, got one on "
                         f"{x.device}")
    check_words(x)
    if not x.is_contiguous():
        raise ValueError("words must be contiguous")
    T, L = x.shape
    tx = torch.empty_like(x)
    inv = torch.empty((T, L), dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        err = _function()(
            x.data_ptr(), WORD_BYTES[x.dtype], T, L, mask, tx.data_ptr(),
            inv.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"bic_encode kernel launch failed: CUDA error "
                           f"{err}")
    bic_encode_cuda.launches += 1
    return tx, inv


#: kernel launches so far; set it to 0 before a run to count that run's
bic_encode_cuda.launches = 0
