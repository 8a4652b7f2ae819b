"""The port's tile-gated matmul (K7, ``zvg_matmul``) in its plain version
against the JAX package: ``zvg_matmul_pallas`` in interpret mode (its
default, as ``tests/test_kernels.py`` runs it) and ``zvg_matmul_ref``, on
the same numpy operands.

The gated map is held bitwise; the product within the stated tolerance of
``repro_torch.kernels.zvg_matmul.cases.TILED_TOL`` (relative to the
largest magnitude, NaN in the same places), over the case list the card
checks use: the shapes, block sweep, planted zero blocks and all-zero
cases of ``test_kernels.py``, a tile of -0.0 (gated: the gate tests
values) and a zero tile with one NaN (live).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.zvg_matmul.kernel import zvg_matmul_pallas
from repro.kernels.zvg_matmul.ref import zvg_matmul_ref as j_zvg_matmul_ref
from repro_torch.kernels import zvg_matmul
from repro_torch.kernels.zvg_matmul.cases import (TILED_CASES, TILED_TOL,
                                                  tiled_case, tiled_error)
from repro_torch.kernels.zvg_matmul.kernel import (SMS, TILED_MAX_SPLITS,
                                                   tiled_plan, tma_operands,
                                                   zvg_matmul_cuda)
from repro_torch.kernels.zvg_matmul.ref import row_is_live, zvg_matmul_ref

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), _JNP[t.dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", TILED_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-b{c[3]}.{c[4]}.{c[5]}"
                              f"-{c[7] or c[6]}" for c in TILED_CASES])
def test_plain_matches_the_jax_kernel(case, dtype):
    M, K, N, bm, bn, bk, zf, plant = case
    a, b = tiled_case(M, K, N, zf, plant, dtype, seed=M + K, device="cpu")
    out, gated = zvg_matmul(a, b, bm, bn, bk)
    assert out.dtype == torch.float32 and gated.dtype == torch.int32
    assert tuple(gated.shape) == (-(-M // bm), -(-K // bk))
    j_out, j_gated = zvg_matmul_pallas(_jax(a), _jax(b), block_m=bm,
                                       block_n=bn, block_k=bk)
    r_out, r_gated = j_zvg_matmul_ref(_jax(a), _jax(b), block_m=bm,
                                      block_k=bk)
    np.testing.assert_array_equal(gated.numpy(), np.asarray(j_gated))
    np.testing.assert_array_equal(gated.numpy(), np.asarray(r_gated))
    for want in (j_out, r_out):
        err = tiled_error(out, torch.from_numpy(np.array(want)))
        assert err <= TILED_TOL[dtype], err
    if plant == "zero_blocks":
        assert int(gated.sum()) == 2
    if plant == "all_zero":
        assert bool((gated == 1).all()) and float(out.abs().max()) == 0.0


def test_the_gate_tests_values_not_bits():
    """-0.0 is zero and gated (K2's row test on bits keeps it live); a
    NaN makes its tile live and reaches the product."""
    a = torch.zeros(128, 256)
    a[:, :128] = -0.0
    a[3, 200] = float("nan")
    b = torch.ones(256, 8)
    out, gated = zvg_matmul(a, b)
    assert gated.tolist() == [[1, 0]]
    assert bool(row_is_live(a)[0])              # the bit test: -0.0 is live
    assert torch.isnan(out[3]).all() and float(out[4:].abs().max()) == 0.0


def test_ref_backend_and_default_agree_on_the_cpu():
    a, b = tiled_case(130, 257, 70, 0.5, None, torch.bfloat16, seed=0,
                      device="cpu")
    got, g = zvg_matmul(a, b, backend="ref")
    want, wg = zvg_matmul_ref(a, b)
    assert torch.equal(got, want) and torch.equal(g, wg)


def test_entries_raise_on_what_they_do_not_take():
    a = torch.randn(16, 32)
    b = torch.randn(32, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        zvg_matmul_cuda(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        zvg_matmul(a, b, backend="cuda")
    assert zvg_matmul_cuda.launches == 0
    with pytest.raises(TypeError, match="share a dtype"):
        zvg_matmul(a, b.to(torch.bfloat16))
    with pytest.raises(TypeError, match="share a dtype"):
        zvg_matmul(a.half(), b.half())
    with pytest.raises(ValueError, match=r"\[M, K\] x \[K, N\]"):
        zvg_matmul(a, b[:5])
    with pytest.raises(ValueError, match="positive"):
        zvg_matmul(a, b, block_k=0)


#: ``(M, K, N, bm, bk)``: ResNet50's site shapes at 224 px (the stem, the
#: 56 x 56 to 7 x 7 stages, the classifier; ``s4b1.c2`` is 49 x 4608 x
#: 512), the quickstart's, and the block sweep of ``TILED_CASES``
PLAN_SHAPES = (
    (12544, 147, 64, 128, 128), (3136, 64, 64, 128, 128),
    (3136, 576, 64, 128, 128), (3136, 64, 256, 128, 128),
    (784, 1152, 128, 128, 128), (784, 128, 512, 128, 128),
    (196, 2304, 256, 128, 128), (196, 256, 1024, 128, 128),
    (49, 4608, 512, 128, 128), (49, 512, 2048, 128, 128),
    (1, 2048, 1000, 128, 128), (128, 512, 128, 128, 128),
    (192, 320, 192, 64, 64), (192, 320, 192, 64, 256),
    (192, 320, 192, 64, 16), (130, 257, 70, 128, 128),
)


@pytest.mark.parametrize("M,K,N,bm,bk", PLAN_SHAPES, ids=str)
def test_tiled_plan_splits_k_in_whole_tiles(M, K, N, bm, bk):
    """Every k lies in exactly one split, each split is a run of whole bk
    tiles (so a skipped stage lies in one gated tile), the output tile
    divides bm, and the grid fills the card or the plan says why not."""
    plan = tiled_plan(M, K, N, bm, bk)
    step = plan.tiles_per_split * bk
    ranges = [(s * step, min(K, (s + 1) * step)) for s in range(plan.splits)]
    assert len(ranges) == plan.splits <= TILED_MAX_SPLITS
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (_, end), (start, _) in zip(ranges, ranges[1:]):
        assert end == start
    for start, end in ranges:
        assert start % bk == 0 and start < end
        assert (end - start) % bk == 0 or end == K
    assert bm % plan.tile_m == 0 and plan.tile_n in (64, 128)
    out_tiles = -(-M // plan.tile_m) * -(-N // plan.tile_n)
    assert plan.blocks == out_tiles * plan.splits
    assert (plan.blocks >= SMS) == (plan.reason is None)
    if out_tiles >= SMS:
        assert plan.splits == 1


def test_the_7x7_site_splits_across_a_cluster():
    """``s4b1.c2`` (49 x 4608 x 512): 8 output tiles would leave the card
    idle; K splits 12 ways in runs of three 128-tiles (96 blocks), as many
    as a cluster of at most 16 allows, and the plan says so."""
    plan = tiled_plan(49, 4608, 512, 128, 128)
    assert (plan.tile_m, plan.tile_n) == (64, 64)
    assert (plan.splits, plan.tiles_per_split, plan.blocks) == (12, 3, 96)
    assert "cluster" in plan.reason


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_tma_operands_zero_pad_k_and_n(dtype):
    """K = 147 (the stem's) and N = 70 have row strides TMA cannot read:
    the copies are padded with zeros to 152 and 72, and the plain version
    on them gives the same gated map and, in the first N columns, the same
    product; aligned operands pass through as they are."""
    a, b = tiled_case(130, 147, 70, 0.5, None, dtype, seed=3, device="cpu")
    ap, bp = tma_operands(a, b)
    assert tuple(ap.shape) == (130, 152) and tuple(bp.shape) == (152, 72)
    assert torch.equal(ap[:, :147], a) and not ap[:, 147:].any()
    assert torch.equal(bp[:147, :70], b) and not bp[147:].any()
    assert not bp[:, 70:].any()
    out, gated = zvg_matmul_ref(a, b)
    pout, pgated = zvg_matmul_ref(ap, bp)
    assert torch.equal(gated, pgated)
    assert torch.equal(out, pout[:, :70])
    a, b = tiled_case(64, 256, 64, 0.5, None, dtype, seed=3, device="cpu")
    ap, bp = tma_operands(a, b)
    assert ap is a and bp is b


#: blocks that are not multiples of the card's row tile (64) or k stage
#: (16): ``(M, K, N, block_m, block_k)``
ODD_BLOCKS = ((70, 90, 40, 32, 8), (200, 130, 24, 96, 24),
              (230, 150, 33, 200, 40))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("M,K,N,bm,bk", ODD_BLOCKS, ids=str)
def test_plain_matches_the_jax_kernel_at_any_blocks(M, K, N, bm, bk, dtype):
    """Blocks of (32, 8), (96, 24) and (200, 40), with zero tiles planted
    among live ones: the gated map equal to ``zvg_matmul_pallas``'s (which
    pads to any block) and the product within the stated tolerance."""
    a, b = tiled_case(M, K, N, 0.5, None, dtype, seed=M + bk, device="cpu")
    a[:bm, :bk] = 0
    a[bm:2 * bm, 2 * bk:3 * bk] = -0.0
    out, gated = zvg_matmul(a, b, bm, 128, bk)
    j_out, j_gated = zvg_matmul_pallas(_jax(a), _jax(b), block_m=bm,
                                       block_n=128, block_k=bk)
    np.testing.assert_array_equal(gated.numpy(), np.asarray(j_gated))
    assert int(gated[0, 0]) == 1 and int(gated[1, 2]) == 1
    err = tiled_error(out, torch.from_numpy(np.array(j_out)))
    assert err <= TILED_TOL[dtype], err


@pytest.mark.parametrize("M,K,N,bm,bk", ODD_BLOCKS + (
    (49, 4608, 512, 32, 8), (3136, 576, 64, 1, 1), (784, 1152, 128, 96, 24)),
    ids=str)
def test_tiled_plan_takes_any_blocks(M, K, N, bm, bk):
    """At any blocks the split covers every k once in whole k stages (a
    stage of 64 where 16 does not divide bk), at most a cluster of them;
    the output tile stays 64 or 128 rows (128 only where bm allows)."""
    plan = tiled_plan(M, K, N, bm, bk)
    assert plan.k_stage in (16, 32, 64)
    assert bk % plan.k_stage == 0 or (bk % 16 and plan.k_stage == 64)
    assert plan.k_per_split % plan.k_stage == 0
    assert plan.splits == -(-K // plan.k_per_split) <= TILED_MAX_SPLITS
    covered = np.zeros(K, dtype=np.int64)
    for s in range(plan.splits):
        covered[s * plan.k_per_split:(s + 1) * plan.k_per_split] += 1
    assert (covered == 1).all()
    assert plan.tile_m in (64, 128) and (plan.tile_m == 64 or bm % 128 == 0)
