"""Stream lengths at the edges of the grouped walk's plans
(:func:`~repro_torch.kernels.power_counters.kernel.counter_plan`), at
which the counter pass (K1) and the BIC encoder (K6) are held to their
plain versions: on the CPU against the JAX package, on the card against
the kernels (``tests/test_torch_cuda.py`` and ``chip_smoke.py`` read them
from here).

For a stream of one or two 32-lane groups the plan cuts T into as many
chunks of at least 4 cycles as it can, up to 128: so 1-5 and 7 cycles
walk in one pass, 8 and 9 in two chunks; 31-33 cut into 4 or 8 chunks in
a block; 63-65 into 8 in a block or 16 across a cluster of 2; 511-513
into 64 or 128 (clusters of 8 or 16); 1023-1025 and ResNet50's deepest
reduction, 4607-4609, into 128 chunks of 8 or 9 and of 36 or 37 cycles
(where T is one more than a multiple of 128, the last chunks are short or
empty). Each edge is T a multiple of the chunks and one more or less.
:func:`chunk_coverage` walks a plan's grid
as the kernels do, for the CPU tests of the plans.
"""
from __future__ import annotations

import numpy as np

PLAN_EDGES = (1, 2, 3, 4, 5, 7, 8, 9, 31, 32, 33, 63, 64, 65, 511, 512,
              513, 1023, 1024, 1025, 4607, 4608, 4609)


def chunk_coverage(plan, B: int, T: int, L: int) -> np.ndarray:
    """How many chunks of ``plan`` cover each ``(b, t, lane)`` of ``B``
    streams ``[T, L]``, walking the grid as ``counters_kernel`` and
    ``bic_encode_kernel`` do: block ``x`` is rank ``x % cluster`` of its
    cluster; its warp ``w`` takes group ``(x // cluster) * (8 // split) +
    w // split`` of the batch's ``B * groups`` and chunk ``rank * split +
    w % split`` of it."""
    from .kernel import WALK_WARPS

    cov = np.zeros((B, T, plan.groups * 32), dtype=np.int64)
    per_block = WALK_WARPS // plan.split
    for x in range(plan.blocks):
        rank = x % plan.cluster
        for w in range(WALK_WARPS):
            item = (x // plan.cluster) * per_block + w // plan.split
            if item >= B * plan.groups:
                continue
            b, g = divmod(item, plan.groups)
            c = rank * plan.split + w % plan.split
            t0 = min(T, c * plan.chunk)
            cov[b, t0:min(T, t0 + plan.chunk), g * 32:(g + 1) * 32] += 1
    return cov[..., :L]
