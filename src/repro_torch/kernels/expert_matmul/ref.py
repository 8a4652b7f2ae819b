"""Plain version of K8: each expert's segment of rows times its own
weights, in tiles of a fixed row count.

``x [P, K]`` holds the rows routed to the experts, sorted by expert:
expert ``e``'s rows are ``offsets[e]:offsets[e + 1]`` (``offsets [E + 1]``
int32, non-decreasing, from 0 to ``P``). ``w [E, K, N]`` holds the
experts' weights. Without ``w_up`` the result is ``x_e @ w[e]`` per
segment; with it, the gated MLP's first half ``act(x_e @ w[e]) * (x_e @
w_up[e])``, each product rounded to the operands' dtype first, as the
model's dense gated MLP rounds it. A row whose words are all +0.0 is
written +0.0 (K2's row gate).

Each segment runs in tiles of :data:`ROW_TILE` rows, zero rows padding
the last: PyTorch's CPU matmul picks its kernel by the row count, so a
row multiplied among 5 rows and the same row alone round apart, and a
token's result would depend on how many other tokens chose its experts.
In a tile of a fixed row count each row's result depends on its own
words alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zvg_matmul.ref import row_is_live

ROW_TILE = 16


def check_operands(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                   w_up: torch.Tensor | None = None) -> None:
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"expert product of x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}: want x [P, K], w [E, K, N]")
    if offsets.shape != (w.shape[0] + 1,):
        raise ValueError(f"offsets {tuple(offsets.shape)} for "
                         f"{w.shape[0]} experts: want [E + 1]")
    if w_up is not None and w_up.shape != w.shape:
        raise ValueError(f"w_up {tuple(w_up.shape)} beside w "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or (w_up is not None and w_up.dtype != w.dtype):
        raise ValueError(f"operands in {x.dtype} and {w.dtype}: one dtype")


def expert_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      offsets: torch.Tensor, w_up: torch.Tensor | None = None,
                      act=None) -> torch.Tensor:
    """``[P, N]`` in ``x``'s dtype (module doc); ``act`` the gate's
    activation (with ``w_up``)."""
    check_operands(x, w, offsets, w_up)
    P, K = x.shape
    out = x.new_zeros((P, w.shape[2]))
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        for r0 in range(bounds[e], bounds[e + 1], ROW_TILE):
            r1 = min(bounds[e + 1], r0 + ROW_TILE)
            tile = x.new_zeros((ROW_TILE, K))
            tile[:r1 - r0] = x[r0:r1]
            y = tile @ w[e]
            if w_up is not None:
                y = act(y) * (tile @ w_up[e])
            out[r0:r1] = y[:r1 - r0]
    return torch.where(row_is_live(x)[:, None], out, out.new_zeros(()))
