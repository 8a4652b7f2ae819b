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
from repro_torch.kernels.power_counters.kernel import (CounterPlan,
                                                       plan_chunks,
                                                       split_plan)
from repro_torch.kernels.transitions.ref import WORD_BYTES, check_words

from .ref import check_mask


@functools.cache
def _function():
    fn = _build.load("bic_encode").be_bic_encode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


#: the warps a K6 launch aims at (fitted as the counter walk's, to a sweep
#: over ResNet50's 54 weight streams on an H100): its step is a popcount
#: and a select, so more and shorter chunks pay than for K1
BIC_FILL = 4096


@functools.lru_cache(maxsize=None)
def bic_plan(T: int, L: int) -> CounterPlan:
    """K6's grid: the counter walk's plan of one ``[T, L]`` stream
    (:func:`~repro_torch.kernels.power_counters.kernel.plan_chunks` toward
    :data:`BIC_FILL` warps, laid out by ``split_plan``); one pass for a
    short stream."""
    if T < 1 or L < 1:
        raise ValueError(f"the encoder needs T, L >= 1, got {(T, L)}")
    return split_plan(1, T, L, plan_chunks(-(-L // 32), T, BIC_FILL))


def bic_encode_cuda(x: torch.Tensor, mask: int,
                    plan: CounterPlan | None = None):
    """Single-segment BIC encode of contiguous words ``[T, L]`` on the
    card, on :func:`bic_plan`'s plan unless ``plan`` is given: ``(tx,
    inv)``, ``tx`` in ``x``'s word dtype and ``inv bool[T, L]``, bit for
    bit :func:`.ref.bic_encode_ref`. Raises on a tensor or mask the kernel
    does not take; never falls back to the plain version."""
    mask = check_mask(mask)
    if x.device.type != "cuda":
        raise ValueError(f"bic_encode_cuda needs a CUDA tensor, got one on "
                         f"{x.device}")
    check_words(x)
    if not x.is_contiguous():
        raise ValueError("words must be contiguous")
    T, L = x.shape
    plan = plan or bic_plan(T, L)
    tx = torch.empty_like(x)
    inv = torch.empty((T, L), dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        err = _function()(
            x.data_ptr(), WORD_BYTES[x.dtype], T, L, mask, plan.chunk,
            plan.split, plan.cluster, tx.data_ptr(), inv.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"bic_encode kernel launch failed: CUDA error "
                           f"{err}")
    bic_encode_cuda.launches += 1
    return tx, inv


#: kernel launches so far; set it to 0 before a run to count that run's
bic_encode_cuda.launches = 0
