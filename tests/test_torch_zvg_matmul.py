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


#: ``(K, N)`` of MiniCPM3-4B's decode products (as the wide route's card
#: cases), and shapes cut by the tiles and the 64-k stage
MINICPM3_PRODUCTS = [(2560, 768), (2560, 256), (2560, 32), (2560, 2560),
                     (2560, 6400), (6400, 2560), (2560, 73448)]
WIDE_RAGGED = [(100, 200, 72), (65, 1000, 136), (129, 4104, 520),
               (16, 8, 8), (300, 136, 1032), (17, 6392, 33000),
               (1000, 65536, 24)]


def _route_operands(case):
    """``(x, w)`` for a routing case: ``M`` rows of MiniCPM3's 2560 x 768
    product unless the case changes a dtype, a width or an alignment."""
    M = {"below": kernel.WIDE_MIN_ROWS - 1,
         "at": kernel.WIDE_MIN_ROWS}.get(case, 128)
    K, N = 2560, 768
    xdt = wdt = torch.bfloat16
    if case == "f32":
        xdt = wdt = torch.float32
    elif case == "int8":
        xdt = wdt = torch.int8
    elif case == "bf16-f32":
        wdt = torch.float32
    elif case == "f32-bf16":
        xdt = torch.float32
    elif case == "bf16-int8":
        wdt = torch.int8
    elif case == "k-ragged":
        K = 2561
    elif case == "n-ragged":
        N = 770
    x = torch.zeros(M, K, dtype=xdt)
    w = torch.zeros(K, N, dtype=wdt)
    if case == "x-unaligned":    # contiguous, 2 bytes past a 16-byte line
        x = torch.zeros(M * K + 1, dtype=xdt)[1:].view(M, K)
    elif case == "w-unaligned":
        w = torch.zeros(K * N + 8, dtype=wdt)[4:4 + K * N].view(K, N)
    return x, w


@pytest.mark.parametrize("case,wide", [
    ("at", True), ("wide", True), ("below", False), ("f32", False),
    ("int8", False), ("bf16-f32", False), ("f32-bf16", False),
    ("bf16-int8", False), ("k-ragged", False), ("n-ragged", False),
    ("x-unaligned", False), ("w-unaligned", False)])
def test_wide_route_takes_bf16_at_many_rows_where_tma_can_read(case, wide):
    """bfloat16 x bfloat16 at and above the crossover takes K2's wide
    route; float32, int8, mixed dtypes, rows TMA cannot describe (K or N
    not a multiple of 8, a base off a 16-byte line) and fewer rows keep
    the stream route."""
    x, w = _route_operands(case)
    if case.endswith("unaligned"):
        assert min(x.data_ptr() % 16, w.data_ptr() % 16) == 0
        assert max(x.data_ptr() % 16, w.data_ptr() % 16) != 0
    assert kernel.wide_route(x, w) is wide


def test_wide_route_crossover_lies_among_the_measured_rows():
    """The crossover is one of the row counts both routes were timed at on
    the card (PERF.md's K2 row)."""
    assert kernel.WIDE_MIN_ROWS in (1, 2, 4, 8, 16, 32, 64, 128)


@pytest.mark.parametrize("M,K,N", [(M, K, N) for M in (16, 64, 65, 128, 256)
                                   for K, N in MINICPM3_PRODUCTS]
                         + WIDE_RAGGED, ids=str)
def test_wide_plan_covers_every_tile_and_k_once(M, K, N):
    """Walking the grid as the kernel does -- block ``b`` takes tiles
    ``b``, ``b + workers``, .. unsplit, tile ``b`` split -- every output
    entry lies in exactly one tile and every tile goes to exactly one
    block; every k row lies in exactly one split, each whole 64-k stages,
    at most a cluster's 16; the grid is one wave (at most a block an
    SM)."""
    plan = kernel.wide_plan(M, K, N)
    tm, tn = plan.tile_m, plan.tile_n
    assert tm == (64 if M <= 64 else 128)
    assert tn == (128 if -(-M // tm) * -(-N // 128) * 8 >= kernel.SMS
                  else 64)
    m_tiles, n_tiles = -(-M // tm), -(-N // tn)
    assert plan.tiles == m_tiles * n_tiles
    owner = np.zeros(plan.tiles, dtype=np.int64)
    for b in range(plan.workers):
        owner[b::plan.workers] += 1
    assert (owner == 1).all()
    rows = np.zeros(M, dtype=np.int64)
    cols = np.zeros(N, dtype=np.int64)
    for t in range(plan.tiles):   # tile t: row tile t % m_tiles, column
        m, n = t % m_tiles, t // m_tiles      # tile t // m_tiles
        if n == 0:
            rows[m * tm:(m + 1) * tm] += 1
        if m == 0:
            cols[n * tn:(n + 1) * tn] += 1
    assert (rows == 1).all() and (cols == 1).all()
    kps = plan.k_per_split
    assert kps % kernel.WIDE_STAGE == 0
    assert 1 <= plan.splits <= kernel.WIDE_MAX_SPLITS
    covered = np.zeros(plan.splits * kps, dtype=np.int64)
    for s in range(plan.splits):
        covered[s * kps:(s + 1) * kps] += 1
    assert (covered[:K] == 1).all()
    assert (plan.splits - 1) * kps < K       # no split past K
    if plan.splits > 1:
        assert plan.workers == plan.tiles
    assert plan.blocks == plan.workers * plan.splits <= kernel.SMS


@pytest.mark.parametrize("K,N", MINICPM3_PRODUCTS, ids=str)
@pytest.mark.parametrize("M", [32, 128])
def test_wide_plan_fills_the_card_at_minicpm3s_decode_products(M, K, N):
    """At the decode cell's 128 rows and the paged cell's 32, each of
    MiniCPM3's products fills the card (the head walks its tiles, one
    block an SM) or the plan says why not: few output tiles, and K's 64-k
    stages split at most 16 ways without a second wave."""
    plan = kernel.wide_plan(M, K, N)
    assert (plan.blocks >= kernel.SMS) == (plan.reason is None)
    if plan.tiles >= kernel.SMS:
        assert (plan.splits, plan.workers) == (1, kernel.SMS)
    else:
        assert plan.reason and str(plan.tiles) in plan.reason
        # twice the splits would pass the SMs (a second wave), a cluster or
        # K's stages; the splits are the power of two in whole stages
        twice = 2 * 2 ** (plan.splits - 1).bit_length()
        stages = -(-K // kernel.WIDE_STAGE)
        assert (twice * plan.tiles > kernel.SMS
                or twice > min(kernel.WIDE_MAX_SPLITS, stages))
        assert plan.splits == -(-stages // -(-stages // (twice // 2)))


def test_wide_plan_walks_the_head_and_splits_the_layers():
    """At 128 rows the head's 574 tiles of 128 x 128 are walked by 132
    blocks unsplit; every layer product splits K across a cluster."""
    head = kernel.wide_plan(128, 2560, 73448)
    assert (head.tiles, head.splits, head.workers) == (574, 1, kernel.SMS)
    assert head.k_per_split >= 2560
    for K, N in MINICPM3_PRODUCTS[:-1]:
        assert kernel.wide_plan(128, K, N).splits > 1


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
