"""The decode-path kernels' plain versions against the JAX package's
Pallas kernels (run in interpret mode on the CPU), on the same inputs.

* ``gated_row_matmul_ref`` vs ``repro.kernels.zvg_matmul.fused.
  gated_row_matmul``: ragged shapes, bf16 and f32, all-zero, -0.0 and
  subnormal rows. +0.0 and -0.0 count as equal: the reference fills
  -0.0 in gated columns whose weights are all negative, the port +0.0
  (its own ungated product; ROADMAP fault 3). bf16 products are bitwise
  equal; f32 ones agree within ``F32_ACC * (|x| @ |w|)``, since XLA's
  CPU dot sums in another order. Values below ``SUBNORMAL_FLOOR`` count
  as zero: XLA's CPU code treats subnormal inputs and results as zero,
  PyTorch's computes with them (a row of 1e-39 words sums to ~1e-37).
* ``fused_matmul_counters_ref`` vs ``fused_matmul_counters``: the four
  counter arrays bitwise, the product as above.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.power_counters.spec import CounterSpec as JSpec
from repro.kernels.zvg_matmul import fused as jfused
from repro_torch.core import bic
from repro_torch.kernels.power_counters import CounterSpec
from repro_torch.kernels.zvg_matmul import kernel, ops, ref

#: f32 products vs XLA's CPU dot: sums of K terms in another order
F32_ACC = 1e-6
#: products of subnormal rows, which XLA's CPU code flushes to zero
SUBNORMAL_FLOOR = 1e-30

SHAPES = [(1, 1, 1), (3, 64, 48), (4, 96, 128), (7, 5, 9), (8, 63, 129),
          (1, 1100, 300), (4, 1024, 256)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    for r, v in zip(range(1, m), (0.0, -0.0, 1e-39)):
        x[r] = v                    # +0.0, -0.0 and subnormal rows
    if n > 1:
        w[:, 0] = -np.abs(w[:, 0]) - 0.01   # a gated column's -0.0 fill
    return x, w


def _pair(x, w, jdt, tdt):
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tdt)
    return jx, jw, tx, tw


def _flush(a):
    return np.where(np.abs(a) < SUBNORMAL_FLOOR, 0.0, a)


def _assert_products(got, want, tx, tw):
    dtype = got.dtype
    got = _flush(got.float().numpy())
    want = _flush(np.asarray(want.astype(jnp.float32)))
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, want)   # +0.0 == -0.0 here
        return
    bound = F32_ACC * (tx.float().abs() @ tw.float().abs()).numpy()
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gated_row_matmul_plain_matches_jax(shape, jdt, tdt):
    x, w = _operands(*shape, seed=sum(shape))
    jx, jw, tx, tw = _pair(x, w, jdt, tdt)
    got = ref.gated_row_matmul_ref(tx, tw)
    assert got.dtype == tdt and got.shape == (shape[0], shape[2])
    _assert_products(got, jfused.gated_row_matmul(jx, jw, interpret=True),
                     tx, tw)


def test_gated_rows_fill_plus_zero_and_only_all_plus_zero_rows_gate():
    x = torch.tensor([[0.0, 0.0], [-0.0, 0.0], [1e-40, 0.0], [0.0, 2.0]])
    w = -torch.ones(2, 3)
    live = ref.row_is_live(x)
    assert live.tolist() == [False, True, True, True]
    out = ref.gated_row_matmul_ref(x, w)
    # the gated row is +0.0 (sign bit clear), the port's ungated product
    assert (out[0].view(torch.int32) == 0).all()
    assert torch.equal(out[:1], x[:1] @ w)
    assert torch.equal(out[1:], x[1:] @ w)


@pytest.mark.parametrize("B,K,N,lanes_w,cols,menu", [
    (4, 1024, 256, 16, 16, "paper"), (1, 1, 1, 16, 16, "paper"),
    (3, 63, 129, 5, 32, "full"), (5, 100, 7, 40, 3, "full")])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_fused_matmul_counters_plain_matches_jax(B, K, N, lanes_w, cols, menu,
                                                 jdt, tdt):
    if menu == "paper":
        specs = [dict(zvg=True), dict(bic_variants=(bic.MANTISSA_ONLY,))]
    else:
        full = dict(bic_variants=tuple(bic.NAMED_SEGMENTS.values()),
                    zvg=True, hist=True)
        specs = [full, full]
    x, w = _operands(B, K, N, seed=K + N)
    jx, jw, tx, tw = _pair(x, w, jdt, tdt)
    # the monitored weights stay float32 masters, as the accountant hands
    jw, tw = jnp.asarray(w), torch.from_numpy(w.copy())
    want = jfused.fused_matmul_counters(jx, jw, JSpec(**specs[0]),
                                        JSpec(**specs[1]), lanes_w, cols,
                                        interpret=True)
    got = ref.fused_matmul_counters_ref(tx, tw, CounterSpec(**specs[0]),
                                        CounterSpec(**specs[1]), lanes_w,
                                        cols)
    for name, g, j in zip(("west_counts", "west_rowzeros", "north_counts",
                           "north_rowzeros"), got[1:], want[1:]):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(j),
                                      err_msg=name)
    _assert_products(got[0], want[0], tx, tw)


def test_dispatch_on_the_cpu_takes_the_plain_version_and_refuses_cuda():
    x, w = torch.randn(3, 8), torch.randn(8, 5)
    before = kernel.gated_row_matmul_cuda.launches
    assert torch.equal(ops.gated_row_matmul(x, w),
                       ref.gated_row_matmul_ref(x, w))
    assert torch.equal(ops.gated_row_matmul(x, w, "ref"),
                       ref.gated_row_matmul_ref(x, w))
    assert kernel.gated_row_matmul_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gated_row_matmul(x, w, "cuda")
    spec = CounterSpec(zvg=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fused_matmul_counters(x, w, spec, spec, 16, 16, "cuda")
    with pytest.raises(ValueError, match="unknown counter backend"):
        ops.gated_row_matmul(x, w, "pallas")


#: int8 operands with a float or int8 partner: ``(x dtype, w dtype)``
INT8_PAIRS = [(jnp.int8, torch.int8, jnp.int8, torch.int8),
              (jnp.int8, torch.int8, jnp.bfloat16, torch.bfloat16),
              (jnp.int8, torch.int8, jnp.float32, torch.float32)]


@pytest.mark.parametrize("jx_dt,tx_dt,jw_dt,tw_dt", INT8_PAIRS,
                         ids=["i8-i8", "i8-bf16", "i8-f32"])
@pytest.mark.parametrize("shape", [(5, 32, 16), (9, 300, 130)], ids=str)
def test_gated_row_matmul_int8_byte_equal_to_jax(shape, jx_dt, tx_dt, jw_dt,
                                                 tw_dt):
    """int8 rows (all-zero ones among them) take the value test and the
    product the reference's ``jnp.result_type``: int8 with int8 gives
    ``x @ w`` mod 256, with a float that float. The weights are small
    integers (int8) or multiples of 1/16 (floats), so every partial sum
    is exact in float32 and int32 and the products are byte-equal."""
    m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    x[1] = 0
    x[m - 1] = 0
    if tw_dt == torch.int8:
        w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    else:
        w = (rng.integers(-8, 9, size=(k, n)) / 16).astype(np.float32)
    jx, jw = jnp.asarray(x, jx_dt), jnp.asarray(w, jw_dt)
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tw_dt)
    got = ref.gated_row_matmul_ref(tx, tw)
    want = jfused.gated_row_matmul(jx, jw, interpret=True)
    assert got.dtype == tw_dt and str(want.dtype) == str(jw.dtype)
    if tw_dt == torch.int8:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:   # +0.0 == -0.0 here (the gated rows' fill)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    assert not got[[1, m - 1]].float().view(torch.int32).any()


def test_operands_the_kernels_do_not_take_raise():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ref.gated_row_matmul_ref(torch.ones(2, 3, dtype=torch.int16),
                                 torch.ones(3, 4, dtype=torch.int16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ref.fused_matmul_counters_ref(
            torch.ones(2, 3, dtype=torch.int8),
            torch.ones(3, 4, dtype=torch.int8), CounterSpec(),
            CounterSpec(), 16, 16)
    with pytest.raises(ValueError, match=r"\[M, K\] x \[K, N\]"):
        ref.gated_row_matmul_ref(torch.ones(2, 3), torch.ones(4, 4))
    # mixed float types give a float32 product, as jnp.result_type does
    out = ref.gated_row_matmul_ref(torch.ones(2, 3, dtype=torch.bfloat16),
                                   torch.ones(3, 4))
    assert out.dtype == torch.float32


#: ``(K, N)`` of Qwen1.5-0.5B's decode matmuls: wq/wk/wv/wo, ffn up and
#: gate, ffn down, the lm head
QWEN_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024), (1024, 151936)]


@pytest.mark.parametrize("K,N", QWEN_SHAPES + [(40000, 256), (65536, 1024)],
                         ids=str)
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16-w", "f32-w"])
def test_decode_plan_covers_k_once_and_fills_the_card(K, N, itemsize):
    """Every k row lies in exactly one split, each a multiple of 8 rows,
    at most a cluster's worth of splits, and no longer than the rows a
    block stages x for at once unless every split of the cluster is in use
    (K above 16 x 2048: such a split stages x in pieces); the grid reaches
    the SMs or the plan says why not. The plan is the same at 4 rows (the
    slot step) and 8 (the paged one): it depends on K, N and the weights'
    type only."""
    plan = kernel.decode_plan(K, N, itemsize)
    kps = plan.k_per_split
    ranges = [(s * kps, min(K, (s + 1) * kps)) for s in range(plan.splits)]
    assert len(ranges) == plan.splits <= kernel.DECODE_MAX_SPLITS
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (_, end), (start, _) in zip(ranges, ranges[1:]):
        assert end == start
    if plan.splits > 1:
        assert plan.k_per_split % 8 == 0
    assert all(0 < end - start for start, end in ranges)
    if plan.splits < kernel.DECODE_MAX_SPLITS:
        assert all(end - start <= kernel.DECODE_MAX_K
                   for start, end in ranges)
    covered = np.zeros(K, dtype=np.int64)
    for start, end in ranges:
        covered[start:end] += 1
    assert (covered == 1).all()
    assert plan.cols == 32 * 16 // itemsize
    assert plan.tiles == -(-N // plan.cols)
    assert plan.blocks == plan.tiles * plan.splits
    assert (plan.blocks >= kernel.SMS) == (plan.reason is None)


def test_decode_plan_leaves_the_lm_head_whole_and_splits_the_rest():
    """The lm head's 594 column tiles fill the card unsplit; the 1024- and
    2816-column layers split K across a cluster."""
    head = kernel.decode_plan(1024, 151936, 2)
    assert (head.splits, head.k_per_split, head.blocks) == (1, 1024, 594)
    for K, N in QWEN_SHAPES[:3]:
        plan = kernel.decode_plan(K, N, 2)
        assert plan.splits > 1 and plan.tiles < kernel.DECODE_BLOCKS
    # a K beyond what 16 splits stage at once plans too: 16 splits, each
    # staging x in pieces
    K = kernel.DECODE_MAX_SPLITS * kernel.DECODE_MAX_K + 8
    long = kernel.decode_plan(K, 64, 2)
    assert long.splits == kernel.DECODE_MAX_SPLITS
    assert long.k_per_split > kernel.DECODE_MAX_K
    assert long.splits * long.k_per_split >= K


def test_fused_matmul_counters_plain_matches_jax_past_four_segments():
    """A spec of 6 unique segments (past the kernel's 4-segment
    instantiation) on both edges, with zvg and hist: the counters bitwise
    equal to the JAX package's."""
    variants = ((0x0003,), (0x000C, 0x0030), (0x00C0,), (0x7F00,),
                (0x8000,), (0x0003, 0x00C0))
    spec = dict(bic_variants=variants, zvg=True, hist=True)
    assert len(CounterSpec(**spec).unique_segments) == 6
    x, w = _operands(3, 70, 20, seed=11)
    jx, jw, tx, tw = _pair(x, w, jnp.bfloat16, torch.bfloat16)
    want = jfused.fused_matmul_counters(jx, jw, JSpec(**spec), JSpec(**spec),
                                        16, 16, interpret=True)
    got = ref.fused_matmul_counters_ref(tx, tw, CounterSpec(**spec),
                                        CounterSpec(**spec), 16, 16)
    for g, j in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    _assert_products(got[0], want[0], tx, tw)


@pytest.mark.parametrize("T", [1, 7, 15, 16, 17, 1023, 1024, 4100, 20000])
def test_chunk_plan_covers_every_cycle_of_every_lane_once(T):
    """K3's counter walk: chunk ``q * warps + w`` of a 32-lane group
    covers cycles ``[c * chunk, min(T, (c + 1) * chunk))``; over the
    cluster's blocks and warps every cycle lies in exactly one chunk (T =
    1, T below a chunk, T not a multiple of one), the cluster is at most
    the portable 8, and the serving shape's K = 1024 takes chunks of 16 in
    a cluster of 8."""
    from repro_torch.kernels.power_counters.kernel import (WALK_MAX_CLUSTER,
                                                           chunk_plan)
    plan = chunk_plan(T)
    assert 1 <= plan.cluster <= WALK_MAX_CLUSTER
    assert plan.chunks == plan.cluster * plan.warps
    covered = np.zeros(T, dtype=np.int64)
    for q in range(plan.cluster):
        for w in range(plan.warps):
            c = q * plan.warps + w
            t0 = min(T, c * plan.chunk)
            covered[t0:min(T, t0 + plan.chunk)] += 1
    assert (covered == 1).all()
    if T == 1024:
        assert (plan.chunk, plan.cluster) == (16, 8)


@pytest.mark.parametrize("MP,PS,B,KV", [(16, 16, 8, 16), (4, 8, 1, 2),
                                        (6, 32, 8, 2), (5, 16, 3, 2),
                                        (40, 16, 2, 2), (3, 100, 1, 1),
                                        (1, 1, 1, 1)], ids=str)
def test_paged_plan_covers_every_position_once(MP, PS, B, KV):
    """K4's split: chunks of whole pages (or 64 positions of a longer
    page), block ``q`` of a (row, KV head)'s cluster walking chunks ``q,
    q + cluster, ...``: every table position lies in exactly one chunk of
    exactly one block; the cluster is at most 8 blocks; the serving shape
    (8 rows, 16 KV heads, 16 pages of 16) gives 512 blocks."""
    plan = kernel.paged_plan(MP, PS, B, KV)
    S = plan.positions
    assert S <= kernel.PAGED_CHUNK
    assert S % PS == 0 or PS > kernel.PAGED_CHUNK
    assert 1 <= plan.cluster <= min(plan.chunks, kernel.PAGED_MAX_CLUSTER)
    covered = np.zeros(MP * PS, dtype=np.int64)
    for q in range(plan.cluster):
        for c in range(q, plan.chunks, plan.cluster):
            covered[c * S:(c + 1) * S] += 1
    assert (covered == 1).all()
    assert plan.blocks == B * KV * plan.cluster
    if (MP, PS, B, KV) == (16, 16, 8, 16):
        assert plan.blocks == 512 >= 256
