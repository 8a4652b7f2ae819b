"""The cases that hold the stream kernels -- the transition counter (K5)
and the BIC encoder (K6) -- to their plain versions on the card, bit for
bit: the shapes, masks and ``init`` of the JAX package's own kernel tests,
K5's shapes on either side of its plan's edges, and for K6 stream lengths
on either side of its walk's load chunks (8 cycles) and of the TPU
kernel's T blocks (256). ``chip_smoke.py`` and the card tests
(``tests/test_torch_cuda.py``) both read them from here.
"""
from __future__ import annotations

import numpy as np
import torch

#: K5: ``(T, L)`` shapes, each run with every mask, without and with an
#: ``init`` row, as uint16 and as int32 words
TRANSITION_SHAPES = ((1, 1), (7, 3), (300, 130), (1000, 17), (33, 257))
TRANSITION_MASKS = (0xFFFF, 0x007F, 0x7F80, 0x8000)

#: K5 at the edges of ``transitions_plan`` (run as TRANSITION_SHAPES are):
#: a thread's load batch (8 cycles) at each lane-tile width (rows of 32,
#: 64, 128 or 256 threads a block), one block against a cluster, lanes on
#: either side of the 16-byte vector (8 uint16, 4 int32 words) and of a
#: 64-lane tile, ResNet50's largest and fc weight streams, and a stream of
#: 65535 * 64 + 1 cycles (the most chunks the earlier kernel's grid took,
#: plus one)
TRANSITION_PLAN_EDGES = ((1, 64), (8, 64), (9, 64), (256, 64), (257, 64),
                         (2048, 64), (2049, 64), (4609, 64), (147, 4),
                         (147, 7), (147, 8), (147, 9), (147, 63), (147, 65),
                         (147, 129), (4608, 512), (2048, 1000),
                         (65535 * 64 + 1, 1))

#: K6: ``(T, L)`` shapes, each run with every mask, as uint16 and int32
BIC_SHAPES = ((1, 1), (9, 5), (256, 128), (257, 129), (1000, 33),
              (1543, 8), (4608, 64))
BIC_MASKS = (0x007F, 0xFFFF)


def stream_words(T: int, L: int, seed: int, device="cuda") -> torch.Tensor:
    """Random ``int32`` words ``[T, L]`` in 0..65535, a third of them zero
    words, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 16, (T, L), generator=g, dtype=torch.int32)
    x[torch.rand((T, L), generator=g) < 1 / 3] = 0
    return x.to(device)


def transition_coverage(plan, T: int, L: int) -> np.ndarray:
    """How many threads of ``plan`` count each ``(t, lane)`` of a ``[T,
    L]`` stream, walking the grid as ``transitions_kernel`` does: block
    ``b`` is rank ``b % cluster`` of tile ``b // cluster``; its thread
    ``(x, y)`` takes lanes ``[v * vec, (v + 1) * vec)`` of lane vector ``v
    = tile * tx + x`` and cycles ``[r * cycles, (r + 1) * cycles)`` of
    thread row ``r = rank * rows + y``, each cut at T and L."""
    lanes = np.zeros(plan.tiles * plan.lanes, dtype=np.int64)
    for v in range(plan.tiles * plan.tx):
        lanes[v * plan.vec:(v + 1) * plan.vec] += 1
    cycles = np.zeros(T, dtype=np.int64)
    for r in range(plan.cluster * plan.rows):
        cycles[min(T, r * plan.cycles):min(T, (r + 1) * plan.cycles)] += 1
    return np.outer(cycles, lanes[:L])
