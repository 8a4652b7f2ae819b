"""Wrapper of the Hopper transition counter (``csrc/transitions.cu``).

The kernel replaces the TPU kernel
``repro/kernels/transitions/kernel.py::transitions_pallas``; the source's
header says how, and what bounds it. Its grid is planned here
(:func:`transitions_plan`). It is built with ``nvcc`` at first use and
called through ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

from .ref import WORD_BYTES, check_words


@functools.cache
def _function():
    fn = _build.load("transitions").tr_count_transitions
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


#: a block's threads and the loads a thread issues at once (``kThreads``
#: and ``kBatch`` in the source), the most blocks of a cluster the plan
#: takes (the portable 8) and a forced one may take (16, non-portable)
TR_THREADS = 256
TR_BATCH = 8
TR_PLAN_CLUSTER = 8
TR_MAX_CLUSTER = 16


@dataclass(frozen=True)
class TransitionPlan:
    """K5's grid over a ``[T, L]`` stream. A thread loads ``vec`` adjacent
    lanes a cycle (16 bytes on the ``"vector"`` route, one word on the
    ``"scalar"`` one); a block of :data:`TR_THREADS` threads holds ``tx``
    lane vectors (a tile of ``lanes = tx * vec`` lanes) across ``rows =
    TR_THREADS // tx`` thread rows, each walking ``cycles`` cycles; a
    tile's rows along T span a cluster of ``cluster`` blocks, and the
    ``tiles`` tiles are independent. Thread row ``r`` of a tile takes
    cycles ``[r * cycles, min(T, (r + 1) * cycles))`` (the last may be
    short or empty)."""
    route: str
    vec: int
    tx: int
    cycles: int
    cluster: int
    tiles: int

    @property
    def lanes(self) -> int:
        return self.tx * self.vec

    @property
    def rows(self) -> int:
        return TR_THREADS // self.tx

    @property
    def blocks(self) -> int:
        return self.tiles * self.cluster

    @property
    def warps(self) -> int:
        return self.blocks * TR_THREADS // 32

    @property
    def batches(self) -> int:
        """Rounds of :data:`TR_BATCH` loads a thread issues."""
        return -(-self.cycles // TR_BATCH)


def _route(L: int, word_bytes: int, aligned: bool):
    """``(route, vec, widths)``: the vector route where L is a multiple of
    the 16-byte vector and the base is aligned, and the lane vectors a
    block may hold across (``tx``), widest first: up to 128 bytes of a row
    a warp's row segment, down to one vector on the vector route."""
    if L < 1:
        raise ValueError(f"the counter needs T, L >= 1, got L = {L}")
    if word_bytes not in (2, 4):
        raise ValueError(f"words are 2 or 4 bytes, got {word_bytes}")
    vec = 16 // word_bytes
    route = "vector" if aligned and L % vec == 0 else "scalar"
    if route == "scalar":
        vec = 1
    nvec = -(-L // vec)
    top = min(1 << (nvec - 1).bit_length(), 128 // (vec * word_bytes), 32)
    widths = ([top >> i for i in range(top.bit_length())]
              if route == "vector" else [top])
    return route, vec, widths


def split_transitions(T: int, L: int, word_bytes: int, cluster: int,
                      aligned: bool = True, tx: int | None = None
                      ) -> TransitionPlan:
    """The plan that cuts each tile's T cycles across ``cluster`` blocks
    (1 to :data:`TR_MAX_CLUSTER`) of ``tx`` lane vectors across (the
    route's widest by default): cycles a thread as few as cover T."""
    if T < 1:
        raise ValueError(f"the counter needs T, L >= 1, got T = {T}")
    if not 1 <= cluster <= TR_MAX_CLUSTER:
        raise ValueError(f"a cluster holds 1 to {TR_MAX_CLUSTER} blocks, "
                         f"got {cluster}")
    route, vec, widths = _route(L, word_bytes, aligned)
    tx = tx or widths[0]
    if tx not in widths:
        raise ValueError(f"a {route} block holds {widths} lane vectors "
                         f"across, not {tx}")
    cycles = -(-T // (cluster * (TR_THREADS // tx)))
    tiles = -(-(-(-L // vec)) // tx)       # lane vectors, then tiles
    return TransitionPlan(route, vec, tx, cycles, cluster, tiles)


@functools.lru_cache(maxsize=None)
def transitions_plan(T: int, L: int, word_bytes: int,
                     aligned: bool = True) -> TransitionPlan:
    """K5's grid. A launch at these sizes is latency: each batch of
    :data:`TR_BATCH` loads costs about one memory latency, a cluster
    barrier about as much. So of every lane-tile width and cluster size
    up to :data:`TR_PLAN_CLUSTER`, the plan takes the fewest batches a
    thread, then no cluster, then the widest tile, then the smallest
    cluster (a stream longer than a cluster covers in one batch gets
    longer chunks, not a larger cluster)."""
    _, _, widths = _route(L, word_bytes, aligned)
    plans = [split_transitions(T, L, word_bytes, cl, aligned, tx)
             for tx in widths for cl in range(1, TR_PLAN_CLUSTER + 1)]
    return min(plans, key=lambda p: (p.batches, p.cluster > 1, -p.tx,
                                     p.cluster))


def transitions_cuda(x: torch.Tensor, mask: int = 0xFFFF,
                     init: torch.Tensor | None = None,
                     plan: TransitionPlan | None = None) -> torch.Tensor:
    """Per-lane transition counts ``int32[L]`` of contiguous words ``[T,
    L]`` on the card, on :func:`transitions_plan`'s plan unless ``plan``
    is given, bit for bit :func:`.ref.transitions_ref`. Raises on a tensor
    or plan the kernel does not take; never falls back to the plain
    version."""
    if x.device.type != "cuda":
        raise ValueError(f"transitions_cuda needs a CUDA tensor, got one "
                         f"on {x.device}")
    check_words(x, init)
    if not x.is_contiguous():
        raise ValueError("words must be contiguous")
    T, L = x.shape
    wb = WORD_BYTES[x.dtype]
    plan = plan or transitions_plan(T, L, wb, x.data_ptr() % 16 == 0)
    if init is not None:
        init = init.to(torch.int32).contiguous()
    out = torch.empty(L, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _function()(
            x.data_ptr(), wb, None if init is None else init.data_ptr(), T,
            L, int(mask) & 0xFFFF, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream, plan.vec,
            plan.tx, plan.cycles, plan.cluster, plan.tiles)
    if err:
        raise RuntimeError(f"transitions kernel launch failed: CUDA error "
                           f"{err}")
    transitions_cuda.launches += 1
    return out


#: kernel launches so far; set it to 0 before a run to count that run's
transitions_cuda.launches = 0
