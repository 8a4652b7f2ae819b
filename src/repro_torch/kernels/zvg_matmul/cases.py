"""The cases and the stated tolerances that hold the paged decode
attention (K4) and the tile-gated matmul (K7) to their plain versions on
the card. ``chip_smoke.py`` and the card tests
(``tests/test_torch_cuda.py``) both read them from here.

The tolerance is on the relative error of the output: ``max |kernel -
plain| <= ATTN_TOL[dtype] * max |plain|`` over each case. In bfloat16
the plain version's einsums round the scores and the probabilities to
bfloat16 before the softmax and before they meet V, the kernel keeps
both in float32; both round the output once. Over ``chip_smoke.py``'s 8
seeds of ``PAGED_CASES`` on an H100 the largest reading was 4.3e-7 in
float32 and 9.15e-3 in bfloat16; each limit is about twice that or
more, and a planted fault (each row's last position cut off) reads up
to 1.1 in both.

The bfloat16 limit alone caught that fault in only 62 of the 80 cases.
So bfloat16 outputs are also held per element against the float32 plain
version of the same bfloat16 inputs (:func:`bf16_ulp_error`): within one
bfloat16 unit in the last place of the float32 value plus
``ATTN_BF16_ABS`` of the largest magnitude. A kernel that computes in
float32 and rounds once reads at most about one half there; the planted
fault reads 11 or more in every one of the 80 cases (the plain versions
on the CPU, ``tests/test_torch_paged_attention.py``).
"""
from __future__ import annotations

import numpy as np
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


#: the absolute term of :func:`bf16_ulp_error`, relative to max |plain|
ATTN_BF16_ABS = 1e-5


def bf16_ulp_error(got: torch.Tensor, want32: torch.Tensor) -> float:
    """``max |got - want32| / (ulp(want32) + ATTN_BF16_ABS * max
    |want32|)``, ulp the spacing of bfloat16 numbers at each float32
    value (at least the smallest normal's): at most 1 for a bfloat16
    output that is the float32 result rounded once, up to the order of
    its sums."""
    want32 = want32.float()
    mag = want32.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bound = ulp + ATTN_BF16_ABS * want32.abs().max()
    return float(((got.float() - want32).abs() / bound).max())


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|``, the measure ``ATTN_TOL`` bounds."""
    diff = (got.float() - want.float()).abs().max()
    return float(diff / want.float().abs().max())


#: K7: max |kernel - plain| <= TILED_TOL * max |plain| over the finite
#: entries, per operand dtype, with NaN in the same places. Both sum the
#: same float32 products (a bfloat16 product is exact in float32), the
#: kernel k in order, the plain version in cuBLAS's order. On an H100 the
#: largest reading over ``chip_smoke.py``'s 8 seeds of ``TILED_CASES`` was
#: 7.2e-7 in float32 and 3.5e-7 in bfloat16, and 9.8e-7 over the 54
#: ResNet50 sites at 224 px (bfloat16, K up to 4608); each limit is about
#: twice the largest.
TILED_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-6}

#: ``(M, K, N, block_m, block_n, block_k, zero fraction, plant)``: the
#: shapes, block sweep and planted cases of the JAX package's own kernel
#: tests, two more plants: a tile of -0.0 (gated) and a zero tile with one
#: NaN (live), and last two in the shape of the ResNet50 site pass: a 7 x 7
#: site cut to K = 1152, which the card splits 9 ways, and a stem-like K
#: of 147, which TMA cannot read unpadded
TILED_CASES = (
    (128, 128, 128, 128, 128, 128, 0.5, None),
    (256, 384, 128, 128, 128, 128, 0.5, None),
    (100, 200, 50, 128, 128, 128, 0.5, None),
    (1, 128, 1, 128, 128, 128, 0.5, None),
    (130, 257, 70, 128, 128, 128, 0.5, None),
    (64, 256, 64, 128, 128, 128, 0.4, None),
    (192, 320, 192, 64, 64, 64, 0.6, None),
    (192, 320, 192, 128, 128, 128, 0.6, None),
    (192, 320, 192, 64, 128, 256, 0.6, None),
    (256, 384, 128, 128, 128, 128, 0.0, "zero_blocks"),
    (128, 256, 128, 128, 128, 128, 0.0, "all_zero"),
    (256, 256, 96, 128, 128, 128, 0.5, "neg_zero_tile"),
    (256, 256, 96, 128, 128, 128, 0.5, "nan_tile"),
    (49, 1152, 256, 128, 128, 128, 0.5, None),
    (200, 147, 64, 128, 128, 128, 0.3, None),
)


def tiled_case(M: int, K: int, N: int, zf: float, plant, dtype: torch.dtype,
               seed: int, device="cuda"):
    """Operands ``a [M, K]`` (normal values, a fraction ``zf`` set to 0)
    and ``b [K, N]`` from numpy's ``default_rng(seed)``, in ``dtype`` on
    ``device``, with ``plant``: ``"zero_blocks"`` zeroes the 128-tiles
    (0, 0) and (1, 2); ``"all_zero"`` zeroes all of ``a``;
    ``"neg_zero_tile"`` fills the 128-tile (0, 1) with -0.0;
    ``"nan_tile"`` zeroes the 128-tile (1, 0) but for one NaN, and zeroes
    the tile (0, 1) beside it."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    a[rng.random((M, K)) < zf] = 0.0
    b = rng.standard_normal((K, N)).astype(np.float32)
    if plant == "zero_blocks":
        a[0:128, 0:128] = 0.0
        a[128:256, 256:384] = 0.0
    elif plant == "all_zero":
        a[:] = 0.0
    elif plant == "neg_zero_tile":
        a[0:128, 128:256] = -0.0
    elif plant == "nan_tile":
        a[128:256, 0:128] = 0.0
        a[130, 5] = np.nan
        a[0:128, 128:256] = 0.0
    elif plant is not None:
        raise ValueError(f"unknown plant {plant!r}")
    return (torch.from_numpy(a).to(dtype).to(device),
            torch.from_numpy(b).to(dtype).to(device))


def tiled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|`` over the entries where ``want``
    is not NaN (0 where ``want`` is all zeros and ``got`` equals it), the
    measure ``TILED_TOL`` bounds; infinite where the NaNs of the two lie
    in different places."""
    got, want = got.float(), want.float()
    nan = torch.isnan(want)
    if not torch.equal(nan, torch.isnan(got)):
        return float("inf")
    diff = (got - want).abs().masked_fill(nan, 0.0).max()
    scale = want.abs().masked_fill(nan, 0.0).max()
    return float(diff / torch.clamp_min(scale, 1e-30))


#: K2's wide route (bfloat16 x bfloat16 on the tensor cores) against the
#: float32 product, per live entry: ``|got - f32| <= WIDE_TOL[0] * |f32| +
#: WIDE_TOL[1] * (|x| @ |w|) + 2**-126`` (``chip_smoke.py``'s and the card
#: tests' K2 rule in bfloat16). The first term is the output's one rounding
#: to bfloat16 (half a unit in the last place is 2**-9 of the value); the
#: second the order of the float32 sums: inside the tensor core over one
#: 64-k stage, then stage by stage into a second accumulator, then the
#: splits in split order, against cuBLAS's order in the float32 product;
#: the last, results below the smallest normal float32. Gated rows (all
#: words +0.0) are +0.0 bit for bit, whatever ``w`` holds.
WIDE_TOL = (2.0 ** -8, 1e-5)

#: ``(K, N)`` of MiniCPM3-4B's decode products: the query down-projection,
#: the latent and rotary key projections, the output projection, the
#: MLP's up and gate, its down, and the head
WIDE_PRODUCTS = ((2560, 768), (2560, 256), (2560, 32), (2560, 2560),
                 (2560, 6400), (6400, 2560), (2560, 73448))

#: rows the wide route's cases take: one and two warpgroups' tiles, their
#: edges, and two row tiles
WIDE_ROWS = (9, 16, 63, 64, 65, 128, 129, 256)

#: ``(M, K, N)`` beside the products: column tiles cut by N, K not a
#: multiple of the 64-k stage, the fewest k rows, and a persistent walk
#: of more tiles than SMs at 300 rows
WIDE_RAGGED = ((100, 200, 72), (65, 1000, 136), (129, 4104, 520),
               (16, 8, 8), (300, 136, 1032), (17, 6392, 33000))

#: plants of :func:`wide_case`
WIDE_PLANTS = (None, "gated_inf", "specials_inf", "dead_tile")


def wide_case(M: int, K: int, N: int, plant, seed: int, device="cuda"):
    """Bfloat16 operands ``x [M, K]`` (normal values) and ``w [K, N]``
    (fan-in scaled), drawn on ``device`` from ``seed``, with ``plant``: ``"gated_inf"`` sets
    every third row from row 1 to +0.0 and one weight of column ``N //
    3`` to inf; ``"specials_inf"`` sets row 1 to -0.0, row 2 to the
    smallest bfloat16 subnormal and row 3 to +0.0 (as many as M allows),
    and the same inf; ``"dead_tile"`` sets every row of the last row tile
    of :func:`.kernel.wide_plan` to +0.0 (all of x where there is one),
    and the same inf."""
    from .kernel import wide_plan

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=g, device=device)
         * K ** -0.5).to(torch.bfloat16)
    if plant == "gated_inf":
        x[1::3] = 0.0
    elif plant == "specials_inf":
        for r, v in zip(range(1, M), (-0.0, 2.0 ** -133, 0.0)):
            x[r] = v
    elif plant == "dead_tile":
        tm = wide_plan(M, K, N).tile_m
        x[(M - 1) // tm * tm:] = 0.0
    elif plant is not None:
        raise ValueError(f"unknown plant {plant!r}")
    if plant is not None:
        w[K // 2, N // 3] = float("inf")
    return x, w


def wide_error(got: torch.Tensor, plain: torch.Tensor, x: torch.Tensor,
               w: torch.Tensor) -> float:
    """Hold K2's output ``got`` and the plain version's ``plain`` to the
    wide route's rule (:data:`WIDE_TOL`): gated rows +0.0 bit for bit in
    both; a live row's entry that the float32 product makes inf or NaN
    (a weight of inf) not finite in either, which a gated row would be;
    every other live entry within the tolerance. Raises where one breaks
    it; returns the largest |got - plain| over the finite entries."""
    from .ref import row_is_live

    live = row_is_live(x)
    for name, out in (("kernel", got), ("plain version", plain)):
        if (out[~live].view(torch.int16) != 0).any():
            raise AssertionError(f"the {name}'s gated rows are not all "
                                 f"+0.0")
    f32 = x.float() @ w.float()
    fin = torch.isfinite(f32) & live[:, None]
    lost = ~torch.isfinite(f32) & live[:, None]
    rel, acc = WIDE_TOL
    bound = (rel * f32.abs() + acc * (x.float().abs() @ w.float().abs())
             + 2.0 ** -126)
    for name, out in (("kernel", got), ("plain version", plain)):
        if torch.isfinite(out.float()[lost]).any():
            raise AssertionError(f"the {name} is finite where a live row "
                                 f"meets an inf weight")
        excess = ((out.float() - f32).abs() - bound)[fin]
        if excess.numel() and float(excess.max()) > 0:
            raise AssertionError(f"the {name} is {float(excess.max())!r} "
                                 f"outside the stated tolerance")
    both = fin & torch.isfinite(got.float()) & torch.isfinite(plain.float())
    diff = (got.float() - plain.float()).abs()[both]
    return float(diff.max()) if diff.numel() else 0.0
