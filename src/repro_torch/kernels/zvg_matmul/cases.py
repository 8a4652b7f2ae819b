"""The cases and the stated tolerance that hold the paged decode attention
(K4) to its plain version on the card. ``chip_smoke.py`` and the card
tests (``tests/test_torch_cuda.py``) both read them from here.

The tolerance is on the relative error of the output: ``max |kernel -
plain| <= ATTN_TOL[dtype] * max |plain|`` over each case. In bfloat16
the plain version's einsums round the scores and the probabilities to
bfloat16 before the softmax and before they meet V, the kernel keeps
both in float32; both round the output once. Over ``chip_smoke.py``'s 8
seeds of ``PAGED_CASES`` on an H100 the largest reading was 4.3e-7 in
float32 and 9.15e-3 in bfloat16; each limit is about twice that or
more, and a planted fault (each row's last position cut off) reads up
to 1.1 in both.
"""
from __future__ import annotations

import torch

#: max |kernel - plain| <= ATTN_TOL * max |plain|, per dtype
ATTN_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}

#: ``(B, kv, rep, hd, ps, mp, softcap)``: rep 1 to 8, hd 16 to 128, pages
#: of 8, 16 and 32, 1 to 8 rows, softcap 0 and 5, and last the serving
#: shape of Qwen1.5-0.5B (8 rows, 16 KV heads, pages of 16, 256 positions)
PAGED_CASES = (
    (1, 2, 1, 64, 8, 4, 0.0),
    (3, 2, 1, 128, 16, 5, 5.0),
    (8, 2, 2, 64, 32, 6, 0.0),
    (5, 2, 2, 128, 8, 4, 5.0),
    (1, 2, 4, 64, 16, 5, 0.0),
    (3, 2, 4, 128, 32, 6, 5.0),
    (8, 2, 8, 64, 8, 4, 0.0),
    (5, 2, 8, 128, 16, 5, 5.0),
    (4, 2, 3, 16, 8, 5, 0.0),
    (8, 16, 1, 64, 16, 16, 0.0),
)


def paged_case(B: int, kv: int, rep: int, hd: int, ps: int, mp: int,
               dtype: torch.dtype, seed: int, device="cuda"):
    """Random ``q [B, 1, kv * rep, hd]`` and pools ``[1 + B * mp, ps, kv,
    hd]`` from ``seed``, and page tables with every awkward case the rows
    allow: lengths that are not multiples of ``ps``; with 2 or more rows,
    row 0 at length 1 and row 1 at the full table ``mp * ps``, sharing
    row 0's first two pages; with 3 or more, the last row dead (an
    all-trash table, length 1). Returns ``(q, k_pool, v_pool, pages
    int32, lengths int32)`` on ``device``."""
    g = torch.Generator().manual_seed(seed)
    P = 1 + B * mp
    q = 2 * torch.randn(B, 1, kv * rep, hd, generator=g)
    kp = torch.randn(P, ps, kv, hd, generator=g)
    vp = torch.randn(P, ps, kv, hd, generator=g)
    pages = (torch.randperm(P - 1, generator=g) + 1)[:B * mp].reshape(B, mp)
    lengths = torch.randint(2, mp * ps, (B,), generator=g)
    lengths = torch.where(lengths % ps == 0, lengths - 1, lengths)
    if B > 1:
        lengths[0] = 1
        lengths[1] = mp * ps
        pages[1, :2] = pages[0, :2]
    if B > 2:
        pages[-1] = 0
        lengths[-1] = 1
    return (q.to(dtype).to(device), kp.to(dtype).to(device),
            vp.to(dtype).to(device), pages.to(torch.int32).to(device),
            lengths.to(torch.int32).to(device))


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|``, the measure ``ATTN_TOL`` bounds."""
    diff = (got.float() - want.float()).abs().max()
    return float(diff / want.float().abs().max())
