"""The cases that hold the stream kernels -- the transition counter (K5)
and the BIC encoder (K6) -- to their plain versions on the card, bit for
bit: the shapes, masks and ``init`` of the JAX package's own kernel tests,
and for K6 stream lengths on either side of its walk's load chunks (8
cycles) and of the TPU kernel's T blocks (256). ``chip_smoke.py`` and the
card tests (``tests/test_torch_cuda.py``) both read them from here.
"""
from __future__ import annotations

import torch

#: K5: ``(T, L)`` shapes, each run with every mask, without and with an
#: ``init`` row, as uint16 and as int32 words
TRANSITION_SHAPES = ((1, 1), (7, 3), (300, 130), (1000, 17), (33, 257))
TRANSITION_MASKS = (0xFFFF, 0x007F, 0x7F80, 0x8000)

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
