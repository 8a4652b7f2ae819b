"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where no NVIDIA GPU is
present; run this tier on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer counters must be bitwise equal; decode products (K2, K3) of the
kernel and of the plain version lie within ``PRODUCT_TOL`` of the float32
product (the rule ``chip_smoke.py`` states), and gated rows are
bit-equal, over the decode shapes, 8 and 9 rows with gated rows among live
ones, the lm head and all four dtype pairs; K2's wide route (bfloat16 on
the tensor cores) holds to ``WIDE_TOL`` over the wide cases, gated rows
+0.0 beside inf weights; the paged decode attention
(K4) lies within ``ATTN_TOL`` of
its plain version, relative to the output's largest magnitude, over the
case list ``chip_smoke.py`` holds it to (both from
``repro_torch.kernels.zvg_matmul.cases``). The stream kernels of the
quickstart path -- the transition counter (K5) and the BIC encoder (K6)
-- are bitwise equal to theirs over the cases of
``repro_torch.kernels.transitions.cases``, and the tile-gated matmul
(K7) has the same gated map and lies within ``TILED_TOL`` over
``TILED_CASES``, ResNet50's split 7 x 7 and padded stem shapes and blocks
that are not multiples of its tiles, and a split of gated tiles writes
+0.0. K2 also takes int8 with each partner (int8 x int8 exactly, ``x @
w`` mod 256) and K past 32768; K3's chunked counter walk is bitwise on
adversarial words at K = 1 to 4100 and 1 to 31 segments; K4 also holds
at the split's edges, and in bfloat16 per element against the float32
plain version. Each wrapper counts one launch a call. This file imports
no JAX: the GPU machine need not have it.
"""
import dataclasses

import pytest
import torch

from repro_torch import design as D
from repro_torch.core import bic, systolic
from repro_torch.kernels.power_counters import CounterSpec, edge_counters
from repro_torch.kernels.power_counters import kernel as k1
from repro_torch.kernels.bic_encode import kernel as k6
from repro_torch.kernels.bic_encode import ref as ref6
from repro_torch.kernels.power_counters.cases import PLAN_EDGES
from repro_torch.kernels.power_counters.ref import fused_counters_ref
from repro_torch.kernels.transitions import kernel as k5
from repro_torch.kernels.transitions import ref as ref5
from repro_torch.kernels.transitions.cases import (BIC_MASKS, BIC_SHAPES,
                                                   TRANSITION_MASKS,
                                                   TRANSITION_PLAN_EDGES,
                                                   TRANSITION_SHAPES,
                                                   stream_words)
from repro_torch.kernels.zvg_matmul import kernel as kz
from repro_torch.kernels.zvg_matmul import ref as zref
from repro_torch.kernels.zvg_matmul.cases import (ATTN_TOL, PAGED_CASES,
                                                  TILED_CASES, TILED_TOL,
                                                  WIDE_PLANTS, WIDE_PRODUCTS,
                                                  WIDE_RAGGED, WIDE_ROWS,
                                                  bf16_ulp_error, paged_case,
                                                  relative_error, tiled_case,
                                                  tiled_error, wide_case,
                                                  wide_error)
from repro_torch.models.attention import decode_attention

pytestmark = pytest.mark.cuda

FULL = CounterSpec(bic_variants=tuple(bic.NAMED_SEGMENTS.values()),
                   zvg=True, hist=True)
#: |out - f32| <= REL * |f32| + ACC * (|x| @ |w|) + 2**-126, per dtype;
#: int8 x int8 is exact, equal to the plain version (x @ w mod 256)
PRODUCT_TOL = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0 ** -8, 1e-5),
               torch.int8: (0.0, 0.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels run only on "
                    "the card")
    return torch.device("cuda")


def _words(shape, seed=0, zf=0.6):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 16, shape, generator=g, dtype=torch.int32)
    r = torch.rand(shape, generator=g)
    x[r < zf] = 0
    x[(r >= zf) & (r < zf + 0.03)] = 0x8000
    x[(r >= zf + 0.03) & (r < zf + 0.05)] = 0x7FC0
    return x


def _assert_same(x, spec, words=None):
    kc, kr = k1.fused_counters_cuda(x if words is None else words, spec)
    pc, pr = fused_counters_ref(x, spec)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc), [spec.rows[i] for i in range(spec.n_rows)
                                 if not torch.equal(kc[..., i, :],
                                                    pc[..., i, :])]
    assert torch.equal(kr, pr)


@pytest.mark.parametrize("T,L", [(1, 1), (7, 33), (257, 129), (4609, 40),
                                 (147, 12544)])
def test_kernel_matches_plain(cuda, T, L):
    x = _words((T, L), seed=T + L).to(cuda)
    _assert_same(x, FULL)
    _assert_same(x, FULL, words=x.to(torch.int16).view(torch.uint16))


def test_kernel_batched_and_31_segments(cuda):
    _assert_same(_words((6, 130, 70), seed=3).to(cuda), FULL)
    singles = tuple((1 << b,) for b in range(15))
    pairs = tuple(((1 << b) | (1 << ((b + 3) % 16)),) for b in range(16))
    spec = CounterSpec(bic_variants=singles + pairs, zvg=True, hist=True)
    assert len(spec.unique_segments) == 31
    _assert_same(_words((300, 45), seed=4).to(cuda), spec)


@pytest.mark.parametrize("L", [1, 33])
@pytest.mark.parametrize("T", PLAN_EDGES)
def test_kernel_at_the_plan_edges(cuda, T, L):
    """K1 at every stream length of ``PLAN_EDGES`` (one pass, a group's
    chunks in a block, across clusters of 2 to 16; T a multiple of the
    chunks and one more or less, short and empty last chunks), int32 and
    uint16 words."""
    x = _words((T, L), seed=T * 3 + L).to(cuda)
    _assert_same(x, FULL)
    _assert_same(x, FULL, words=x.to(torch.int16).view(torch.uint16))


@pytest.mark.parametrize("T", [1, 7, 9, 31, 33, 63, 65, 147, 1025])
def test_kernel_at_the_plan_edges_wide(cuda, T):
    """K1 over 12544 lanes (ResNet50's stem width: 392 groups, the plan's
    block route) at the plan's edges."""
    x = _words((T, 12544), seed=T).to(cuda)
    _assert_same(x, FULL, words=x.to(torch.int16).view(torch.uint16))


@pytest.mark.parametrize("B,T,L", [(5, 33, 33), (3, 4609, 20),
                                   (7, 1025, 45), (1024, 9, 64),
                                   (32, 9, 3136), (2, 129, 12544),
                                   (65535, 1, 1)], ids=str)
def test_kernel_batches_with_ragged_lanes(cuda, B, T, L):
    """Batches whose groups share blocks across streams (one pass, 8
    groups a block) or split T (block and cluster routes), ragged L."""
    x = _words((B, T, L), seed=B + T + L).to(cuda)
    _assert_same(x, FULL, words=x.to(torch.int16).view(torch.uint16))


def test_kernel_31_segments_at_4609(cuda):
    """The widest spec on the longest plan: 31 unique segments, zvg and
    hist, T = 4609 (128 chunks of 37 in clusters of 16), both words."""
    singles = tuple((1 << b,) for b in range(15))
    pairs = tuple(((1 << b) | (1 << ((b + 3) % 16)),) for b in range(16))
    spec = CounterSpec(bic_variants=singles + pairs, zvg=True, hist=True)
    assert len(spec.unique_segments) == 31
    x = _words((4609, 40), seed=31).to(cuda)
    _assert_same(x, spec)
    _assert_same(x, spec, words=x.to(torch.int16).view(torch.uint16))


@pytest.mark.parametrize("chunks", [1, 2, 4, 8, 16, 32, 64, 128])
def test_kernel_every_route_equals_plain(cuda, chunks):
    """Whatever the plan, the counters are the plain version's: every
    chunk count a group can take (one pass, 2-8 warps of a block,
    clusters of 2-16) on one batch of ragged streams."""
    x = _words((2, 1000, 70), seed=chunks).to(cuda)
    plan = k1.split_plan(2, 1000, 70, chunks)
    kc, kr = k1.fused_counters_cuda(x, FULL, plan)
    pc, pr = fused_counters_ref(x, FULL)
    assert torch.equal(kc, pc) and torch.equal(kr, pr)


def test_auto_backend_launches_the_kernel(cuda):
    x = _words((64, 48), seed=5).to(cuda)
    before = k1.fused_counters_cuda.launches
    out = edge_counters(x, FULL)
    assert k1.fused_counters_cuda.launches == before + 1
    ref = edge_counters(x, FULL, backend="ref")
    assert k1.fused_counters_cuda.launches == before + 1
    for k in out:
        assert torch.equal(out[k], ref[k]), k


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = _words((16, 8)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_counters_cuda(x.t(), FULL)
    with pytest.raises(TypeError, match="uint16 or int32"):
        k1.fused_counters_cuda(x.to(torch.int64), FULL)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.fused_counters_cuda(x.cpu(), FULL)
    with pytest.raises(ValueError, match=r"\[T, L\]"):
        k1.fused_counters_cuda(x[0], FULL)


def test_edge_streams_hand_the_kernel_uint16_words(cuda):
    g = torch.Generator().manual_seed(7)
    A = torch.relu(torch.randn(75, 300, generator=g))
    W = torch.randn(300, 40, generator=g) * 0.05
    for got, want in zip(systolic.edge_streams(A.to(cuda), W.to(cuda)),
                         systolic.edge_streams(A, W)):
        assert got.dtype == torch.uint16 and got.is_contiguous()
        assert torch.equal(got.to(torch.int32).cpu(), want)


def test_design_report_on_the_card_equals_plain(cuda):
    g = torch.Generator().manual_seed(6)
    A = torch.relu(torch.randn(75, 300, generator=g))
    W = torch.randn(300, 40, generator=g) * 0.05
    kw = dict(west_bic=tuple(bic.NAMED_SEGMENTS.values()),
              north_bic=tuple(bic.NAMED_SEGMENTS.values()),
              west_zvg=True, north_zvg=True)
    got = systolic.sa_design_report(A.to(cuda), W.to(cuda), **kw)
    want = systolic.sa_design_report(A, W, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    designs = tuple(D.named_designs().values())
    ev_gpu = D.evaluate_batched(A.reshape(3, 25, 300).to(cuda),
                                W.reshape(3, 100, 40)[:, :, :1]
                                .repeat(1, 3, 1).to(cuda), designs)
    ev_cpu = D.evaluate_batched(A.reshape(3, 25, 300),
                                W.reshape(3, 100, 40)[:, :, :1]
                                .repeat(1, 3, 1), designs)
    for name in ev_cpu:
        for c, v in ev_cpu[name]["energy"].items():
            assert float(ev_gpu[name]["energy"][c]) == float(v), (name, c)


def _decode_operands(M, K, N, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    w = torch.randn(K, N, generator=g) * K ** -0.5
    for r, v in zip(range(1, M, 2), (0.0, -0.0, 1e-39)):
        x[r] = v
    return x.to(dtype).cuda(), w.to(dtype).cuda()


def _assert_product(got, plain, x, w):
    gated = ~zref.row_is_live(x)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got[gated].view(bits), plain[gated].view(bits))
    f32 = x.float() @ w.float()
    rel, acc = PRODUCT_TOL[got.dtype]
    bound = (rel * f32.abs() + acc * (x.float().abs() @ w.float().abs())
             + 2.0 ** -126)
    for out in (got, plain):
        assert ((out.float() - f32).abs() <= bound).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("M,K,N", [(4, 1024, 1024), (4, 2816, 1024),
                                   (7, 63, 129), (1, 1, 1), (3, 1, 129)])
def test_gated_row_matmul_kernel_matches_plain(cuda, M, K, N, dtype):
    x, w = _decode_operands(M, K, N, dtype, seed=M + K + N)
    before = kz.gated_row_matmul_cuda.launches
    got = kz.gated_row_matmul_cuda(x, w)
    assert kz.gated_row_matmul_cuda.launches == before + 1
    plain = zref.gated_row_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    _assert_product(got, plain, x, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("M,K,N", [(2, 2048, 49155), (4, 2048, 49155),
                                   (2, 8192, 22016), (2, 22016, 8192),
                                   (2, 4096, 32064)])
def test_gated_row_matmul_at_the_zoo_shapes(cuda, M, K, N, dtype):
    """The decode shapes the new archs bring: Granite-3.0-2B's tied head
    (N = 49155, not a multiple of 8: the scalar column route),
    DeepSeek-67B's MLP (K = 8192, N = 22016 and back) and Phi-3.5-MoE's
    head."""
    x, w = _decode_operands(M, K, N, dtype, seed=M + K + N)
    before = kz.gated_row_matmul_cuda.launches
    got = kz.gated_row_matmul_cuda(x, w)
    assert kz.gated_row_matmul_cuda.launches == before + 1
    plain = zref.gated_row_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    _assert_product(got, plain, x, w)


@pytest.mark.parametrize("M,K,N,dtype", [
    (2, 2560, 32, torch.bfloat16), (2, 2560, 32, torch.float32),
    (2, 2048, 64, torch.bfloat16), (2, 2048, 64, torch.float32),
    (2, 4096, 256, torch.bfloat16), (2, 4096, 256, torch.float32),
    (2, 8192, 29568, torch.bfloat16), (2, 8192, 152064, torch.bfloat16)],
    ids=str)
def test_gated_row_matmul_at_the_rest_of_the_zoo(cuda, M, K, N, dtype):
    """The decode shapes the rest of the zoo brings: MiniCPM3's ``w_kr``
    (N = 32), DeepSeek-V2-Lite's (N = 64), RecurrentGemma's one-KV-head
    ``wk``/``wv`` (N = 256, hd 256), and in bf16, as served, Qwen2-VL-72B's
    MLP up and its head (8192 x 152064, 2.5 GB), drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device="cuda")
    x[1] = 0.0
    w = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
    x, w = x.to(dtype), w.to(dtype)
    before = kz.gated_row_matmul_cuda.launches
    got = kz.gated_row_matmul_cuda(x, w)
    assert kz.gated_row_matmul_cuda.launches == before + 1
    plain = zref.gated_row_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    _assert_product(got, plain, x, w)


@pytest.mark.parametrize("M,K,N", [(M, K, N) for M in WIDE_ROWS
                                   for K, N in WIDE_PRODUCTS]
                         + list(WIDE_RAGGED), ids=str)
def test_gated_row_matmul_wide_route_matches_plain(cuda, monkeypatch, M, K,
                                                   N):
    """K2's wide route (bfloat16 on the tensor cores), every row count
    forced onto it, at MiniCPM3-4B's decode products and ragged shapes,
    with each plant: gated rows +0.0 bit for bit whatever ``w`` holds
    (inf included), -0.0 and subnormal rows live, a row tile with every
    row gated; live rows within ``WIDE_TOL``; two calls byte-identical;
    one launch a call, counted in ``launches`` and ``wide_launches``."""
    monkeypatch.setattr(kz, "WIDE_MIN_ROWS", 1)
    for plant in WIDE_PLANTS:
        x, w = wide_case(M, K, N, plant, seed=M + K + N)
        before = (kz.gated_row_matmul_cuda.launches,
                  kz.gated_row_matmul_cuda.wide_launches)
        got = kz.gated_row_matmul_cuda(x, w)
        again = kz.gated_row_matmul_cuda(x, w)
        assert (kz.gated_row_matmul_cuda.launches,
                kz.gated_row_matmul_cuda.wide_launches) == (before[0] + 2,
                                                            before[1] + 2)
        plain = zref.gated_row_matmul_ref(x, w)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (M, N)
        assert torch.equal(got.view(torch.int16), again.view(torch.int16))
        wide_error(got, plain, x, w)


@pytest.mark.parametrize("dtype,M", [
    (torch.bfloat16, 128), (torch.bfloat16, 1), (torch.float32, 128)],
    ids=str)
def test_gated_row_matmul_routes_by_rows_and_dtype(cuda, dtype, M):
    """The wrapper picks the route from what it sees: bfloat16 at the
    crossover's rows or more on the tensor cores, the rest on
    ``stream_kernel``'s route; both match the plain version."""
    x, w = _decode_operands(M, 2560, 768, dtype, seed=M)
    before = kz.gated_row_matmul_cuda.wide_launches
    got = kz.gated_row_matmul_cuda(x, w)
    wide = dtype == torch.bfloat16 and M >= kz.WIDE_MIN_ROWS
    assert kz.gated_row_matmul_cuda.wide_launches == before + wide
    plain = zref.gated_row_matmul_ref(x, w)
    torch.cuda.synchronize()
    _assert_product(got, plain, x, w)


@pytest.mark.parametrize("d,K,N", [(2560, 2560, 256), (4096, 4096, 4096),
                                   (2048, 2048, 3072), (2048, 4096, 4096)],
                         ids=["minicpm3 w_dkv", "recurrentgemma in_x",
                              "deepseek-v2-lite wq", "xlstm wq"])
def test_fused_matmul_counters_at_the_new_monitor_weights(cuda, d, K, N):
    """K3 through the power accountant's decode path at the rest of the
    zoo's monitored layer-0 weights (``pick_monitor_weights``):
    MiniCPM3's ``w_dkv``, RecurrentGemma's ``in_x``, DeepSeek-V2-Lite's
    3-D ``wq`` flattened to 2048 x 3072, and xLSTM's ``wq`` (K = 4096
    against 2048-wide activations, both sampled to the monitor's depth):
    counters bitwise equal to the plain producer's, product within K2's
    rule."""
    from repro_torch.core import monitor
    from repro_torch.serve import power

    g = torch.Generator(device="cuda").manual_seed(d + K + N)
    A = torch.randn(4, d, generator=g, device="cuda").to(torch.bfloat16)
    A[2] = 0.0
    W = torch.randn(K, N, generator=g, device="cuda")
    mcfg = monitor.DEFAULT_MONITOR
    before = kz.fused_matmul_counters_cuda.launches
    fused = power._fused_decode_counters(A, W, mcfg, "cuda")
    assert kz.fused_matmul_counters_cuda.launches == before + 1
    plain = power._ref_decode_counters(A, W, dataclasses.replace(
        mcfg, backend="ref"))
    torch.cuda.synchronize()
    for f, p in zip(fused[:4], plain):
        assert torch.equal(f, p)
    A2, W2 = power._subsample_decode(A, W, mcfg)
    _assert_product(fused[4], zref.gated_row_matmul_ref(A2, W2), A2, W2)


def _sweep_sites(B: int, seed: int):
    """``[B, 96, 96]`` sites as the sweep fits them: bfloat16, ReLU'd
    activations with extra zeros, small weights."""
    g = torch.Generator().manual_seed(seed)
    A = torch.relu(torch.randn(B, 96, 96, generator=g))
    A[torch.rand(A.shape, generator=g) < 0.3] = 0.0
    W = torch.randn(B, 96, 96, generator=g) * 0.05
    return A.to(torch.bfloat16), W.to(torch.bfloat16)


@pytest.mark.parametrize("precision", ["fp8e4m3", "int8", "bf16"])
@pytest.mark.parametrize("geom", [(16, 16), (8, 32), (64, 4)], ids=str)
def test_sweep_group_counters_on_the_card_equal_plain(cuda, precision,
                                                      geom):
    """One ``(geometry, precision)`` group of the design sweep: the menu
    its points need, counted by K1 (one launch an edge) on batched
    ``[B, 96, 96]`` sites in the format's embedded words, bitwise equal to
    the plain version on the CPU."""
    from repro_torch.design import menu_args
    from repro_torch.design.sweep import sweep_grid

    A, W = _sweep_sites(12, seed=geom[0] + len(precision))
    (key, kw), = menu_args(sweep_grid(geometries=(geom,),
                                      precisions=(precision,))).items()
    before = k1.fused_counters_cuda.launches
    got = systolic.sa_design_report(A.to(cuda), W.to(cuda), key[0],
                                    precision=precision, **kw)
    assert k1.fused_counters_cuda.launches == before + 2
    want = systolic.sa_design_report(A, W, key[0], precision=precision,
                                     backend="ref", **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_sweep_report_on_the_card_equals_plain(cuda):
    """The full 320-point grid over 10 sites: the rows with K1 on every
    group are those of the plain version, to the bit."""
    from repro_torch.design.sweep import (SweepSites, build_sweep_report,
                                          sweep_grid)

    A, W = _sweep_sites(10, seed=9)
    wts = torch.linspace(0.5, 5.0, 10)
    names = [f"s{i}" for i in range(10)]
    grid = sweep_grid()
    before = k1.fused_counters_cuda.launches
    got = build_sweep_report(SweepSites(A.to(cuda), W.to(cuda), wts, names,
                                        (96, 96, 96)), grid, backend="auto")
    assert k1.fused_counters_cuda.launches == before + 2 * 24
    want = build_sweep_report(SweepSites(A.to(cuda), W.to(cuda), wts, names,
                                         (96, 96, 96)), grid, backend="ref")
    assert got.rows == want.rows
    assert (got.front, got.beats_fixed) == (want.front, want.beats_fixed)


@pytest.mark.parametrize("B,K,N,lanes_w,cols", [
    (4, 1024, 256, 16, 16), (3, 63, 129, 5, 32), (1, 1, 1, 16, 16)])
def test_fused_matmul_counters_kernel_matches_plain(cuda, B, K, N, lanes_w,
                                                    cols):
    a, _ = _decode_operands(B, K, N, torch.bfloat16, seed=K)
    _, w = _decode_operands(B, K, N, torch.float32, seed=N)
    for wspec, nspec in ((CounterSpec(zvg=True),
                          CounterSpec(bic_variants=(bic.MANTISSA_ONLY,))),
                         (FULL, FULL)):
        got = kz.fused_matmul_counters_cuda(a, w, wspec, nspec, lanes_w,
                                            cols)
        want = zref.fused_matmul_counters_ref(a, w, wspec, nspec, lanes_w,
                                              cols)
        torch.cuda.synchronize()
        for g, p in zip(got[1:], want[1:]):
            assert torch.equal(g, p)
        _assert_product(got[0], want[0], a, w)


def _adversarial(shape, dtype, seed):
    """Normal values with zeros, -0.0, NaN, subnormal and all-zero rows
    and columns mixed in."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    r = torch.rand(shape, generator=g)
    x[r < 0.5] = 0.0
    x[(r >= 0.5) & (r < 0.53)] = -0.0
    x[(r >= 0.53) & (r < 0.55)] = float("nan")
    x[(r >= 0.55) & (r < 0.57)] = 1e-39
    x[..., 1::7] = 0.0                     # all-zero lanes
    if shape[0] > 2:
        x[2] = 0.0
    return x.to(dtype).cuda()


def _assert_product_nan(got, plain, x, w):
    """NaN in the same places; elsewhere K2's product rule."""
    nan = torch.isnan(plain)
    assert torch.equal(torch.isnan(got), nan)
    xf, wf = x.float().nan_to_num(0.0), w.float().nan_to_num(0.0)
    f32 = xf @ wf
    rel, acc = PRODUCT_TOL[got.dtype]
    bound = rel * f32.abs() + acc * (xf.abs() @ wf.abs()) + 2.0 ** -126
    for out in (got, plain):
        assert ((out.float() - f32).abs() <= bound)[~nan].all()


def _segment_specs(n_segs):
    """West and north specs with n_segs unique segments: zvg and hist on
    and off in turn."""
    singles = tuple((1 << b,) for b in range(15))
    pairs = tuple(((1 << b) | (1 << ((b + 3) % 16)),) for b in range(16))
    menu = {1: (bic.MANTISSA_ONLY,),
            4: ((0x000F,), (0x00F0,), (0x0F00,), (0xF000,)),
            5: ((0x0003,), (0x000C, 0x0030), (0x00C0,), (0x7F00,),
                (0x0003, 0x00C0)),
            31: singles + pairs + (tuple(1 << b for b in range(15)),)}
    variants = menu[n_segs]
    west = CounterSpec(bic_variants=variants, zvg=n_segs % 2 == 1,
                       hist=n_segs >= 5)
    north = CounterSpec(bic_variants=variants, zvg=n_segs != 5,
                        hist=n_segs == 4)
    assert len(west.unique_segments) == n_segs
    return west, north


@pytest.mark.parametrize("n_segs", [1, 4, 5, 31])
@pytest.mark.parametrize("T", [1, 7, 1023, 1024, 4100])
def test_fused_matmul_counters_chunked_walk_bitwise(cuda, T, n_segs):
    """K3's chunked walk against the plain counter pass, bitwise, on
    adversarial words (NaN, -0.0, subnormal, all-zero lanes and rows), K
    = T of 1 (one chunk), 7 (below a chunk), 1023 and 1024 (the serving
    shape's chunks of 16) and 4100 (chunks of 65), 1 to 31 unique
    segments, zvg and hist on and off, 1 and 9 request rows; the product
    as K2's. One launch counted a call."""
    B = 9 if (T + n_segs) % 2 else 1
    wspec, nspec = _segment_specs(n_segs)
    a = _adversarial((B, T), torch.bfloat16, seed=T + n_segs)
    w = _adversarial((T, 40), torch.float32, seed=T * n_segs)
    before = kz.fused_matmul_counters_cuda.launches
    got = kz.fused_matmul_counters_cuda(a, w, wspec, nspec, 16, 16)
    assert kz.fused_matmul_counters_cuda.launches == before + 1
    want = zref.fused_matmul_counters_ref(a, w, wspec, nspec, 16, 16)
    torch.cuda.synchronize()
    for name, g, p in zip(("west_counts", "west_rowzeros", "north_counts",
                           "north_rowzeros"), got[1:], want[1:]):
        assert torch.equal(g, p), name
    _assert_product_nan(got[0], want[0], a, w)


#: int8 with each partner: ``(x dtype, w dtype)``
INT8_PAIRS = [(torch.int8, torch.int8), (torch.int8, torch.bfloat16),
              (torch.int8, torch.float32)]


@pytest.mark.parametrize("xdt,wdt", INT8_PAIRS,
                         ids=["i8-i8", "i8-bf16", "i8-f32"])
@pytest.mark.parametrize("M,K,N", [(4, 1024, 1024), (8, 2816, 1024),
                                   (9, 300, 129)], ids=str)
def test_gated_row_matmul_int8(cuda, M, K, N, xdt, wdt):
    """int8 rows (all-zero ones among them) with int8, bfloat16 and
    float32 weights: int8 x int8 equal to the plain version (x @ w mod
    256), the float pairs within K2's product rule; gated rows zero."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
    x[[1, M - 1]] = 0
    if wdt == torch.int8:
        w = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8)
    else:
        w = (torch.randn(K, N, generator=g) * K ** -0.5).to(wdt)
    x, w = x.cuda(), w.cuda()
    before = kz.gated_row_matmul_cuda.launches
    got = kz.gated_row_matmul_cuda(x, w)
    assert kz.gated_row_matmul_cuda.launches == before + 1
    plain = zref.gated_row_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert got.dtype == plain.dtype == torch.promote_types(xdt, wdt)
    assert not got[[1, M - 1]].float().view(torch.int32).any()
    if wdt == torch.int8:   # PRODUCT_TOL[int8]: exact
        assert PRODUCT_TOL[torch.int8] == (0.0, 0.0)
        assert torch.equal(got, plain)
    else:
        _assert_product(got, plain, x, w)


@pytest.mark.parametrize("K", [40000, 65536])
def test_gated_row_matmul_past_the_staging_limit(cuda, K):
    """K above 16 x 2048: each of the 16 splits stages x in pieces; gated
    rows bit-equal, the product within the rule."""
    x, w = _pair_operands(4, K, 256, torch.bfloat16, torch.bfloat16, (1,),
                          seed=K)
    assert kz.decode_plan(K, 256, 2).k_per_split > kz.DECODE_MAX_K
    got = kz.gated_row_matmul_cuda(x, w)
    plain = zref.gated_row_matmul_ref(x, w)
    torch.cuda.synchronize()
    _assert_product(got, plain, x, w)


def test_decode_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x, w = _decode_operands(4, 8, 6, torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        kz.gated_row_matmul_cuda(x, w.t().contiguous().t())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kz.gated_row_matmul_cuda(x.half(), w.half())
    with pytest.raises(ValueError, match="CUDA tensors"):
        kz.gated_row_matmul_cuda(x, w.cpu())


def test_serve_engine_on_the_card_kernels_equal_plain(cuda):
    """Smoke-size serving on the card: the kernels' run and the plain
    versions' run give equal tokens and bitwise-equal energies."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import lm
    from repro_torch.serve import SamplingParams, ServeConfig, ServeEngine

    cfg = SMOKES["qwen1.5-0.5b"].with_(compute_dtype="float32")
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (int(n),), generator=g).tolist()
               for n in torch.randint(2, 24, (6,), generator=g)]
    runs = []
    for backend in ("auto", "ref"):
        eng = ServeEngine(params, cfg, ServeConfig(
            max_slots=3, cache_len=48, power_monitor=True, seed=3,
            kernel_backend=backend))
        counted = (k1.fused_counters_cuda, kz.gated_row_matmul_cuda,
                   kz.fused_matmul_counters_cuda)
        before = [fn.launches for fn in counted]
        for i, p in enumerate(prompts):
            eng.submit(p, max_new_tokens=5, sampling=SamplingParams()
                       if i % 2 == 0 else SamplingParams(0.8, 5))
        runs.append({r.uid: r for r in eng.run()})
        launched = [fn.launches - b for fn, b in zip(counted, before)]
        assert all(launched) if backend == "auto" else not any(launched)
    for uid, r in runs[0].items():
        if uid % 2 == 0:
            assert r.generated == runs[1][uid].generated
        if r.generated == runs[1][uid].generated:
            assert r.power.energy == runs[1][uid].power.energy


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=["B{}-kv{}-rep{}-hd{}-ps{}-mp{}-cap{}".format(*c)
                              for c in PAGED_CASES])
def test_paged_attention_kernel_matches_plain(cuda, dtype, case):
    *shape, softcap = case
    q, kp, vp, pages, lengths = paged_case(*shape, dtype, seed=sum(shape))
    before = kz.fused_paged_attention_cuda.launches
    got = kz.fused_paged_attention_cuda(q, kp, vp, pages, lengths,
                                        softcap=softcap)
    assert kz.fused_paged_attention_cuda.launches == before + 1
    want = zref.fused_paged_attention_ref(q, kp, vp, pages, lengths,
                                          decode_attention, softcap=softcap)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert relative_error(got, want) <= ATTN_TOL[dtype]
    if dtype == torch.bfloat16:
        f32 = [t.float() for t in (q, kp, vp)]
        want32 = zref.fused_paged_attention_ref(*f32, pages, lengths,
                                                decode_attention,
                                                softcap=softcap)
        assert bf16_ulp_error(got, want32) <= 1


#: the split's edges: ``(name, (B, kv, rep, hd, ps, mp), lengths)``; a
#: split is 64 positions, a cluster at most 8 splits (512 positions)
SPLIT_EDGES = (
    ("lengths-1", (4, 2, 2, 64, 16, 16), (1, 1, 1, 1)),
    ("split-boundaries", (5, 2, 1, 64, 16, 16), (64, 128, 192, 65, 63)),
    ("wider-than-a-cluster", (3, 2, 4, 64, 16, 40), (640, 513, 511)),
    ("rep8-hd128", (3, 2, 8, 128, 16, 12), (192, 70, 1)),
    ("length-0", (3, 2, 2, 32, 8, 10), (0, 80, 0)),
)


def _attention64(q, kp, vp, pages, lengths):
    """The plain paged attention in float64: the gather, then the dense
    decode attention's einsums and softmax, every step in float64."""
    k = zref.gather_pages(kp.double(), pages)
    v = zref.gather_pages(vp.double(), pages)
    b, _, h, d = q.shape
    rep = h // k.shape[2]
    qg = q.double().reshape(b, k.shape[2], rep, d)
    scores = torch.einsum("bkrd,bskd->bkrs", qg, k) * d ** -0.5
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            < lengths[:, None].long())
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkrs,bskd->bkrd", probs, v).reshape(b, 1, h, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name,shape,lengths", SPLIT_EDGES,
                         ids=[e[0] for e in SPLIT_EDGES])
def test_paged_attention_split_edges(cuda, dtype, name, shape, lengths):
    """The split's edges within ``ATTN_TOL``: bfloat16 of the plain
    version (and per element of the float32 plain version), float32 of
    the plain version computed in float64. (On the 640-position row the
    float32 plain version is itself 2.1e-6 from float64 on an H100, the
    kernel 1.4e-7: the float32 limit of 2e-6 was set on rows of 192
    positions at most.) A row of length 0 is zeros: the plain version's
    dense attention has no such row to mask."""
    q, kp, vp, pages, _ = paged_case(*shape, dtype, seed=len(name))
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = kz.fused_paged_attention_cuda.launches
    got = kz.fused_paged_attention_cuda(q, kp, vp, pages, lengths)
    assert kz.fused_paged_attention_cuda.launches == before + 1
    if dtype == torch.float32:
        want = _attention64(q, kp, vp, pages, lengths)
    else:
        want = zref.fused_paged_attention_ref(q, kp, vp, pages, lengths,
                                              decode_attention)
    torch.cuda.synchronize()
    live = lengths > 0
    assert not got[~live].float().view(torch.int32).any()
    assert relative_error(got[live], want[live]) <= ATTN_TOL[dtype]
    if dtype == torch.bfloat16:
        want32 = zref.fused_paged_attention_ref(
            *[t.float() for t in (q, kp, vp)], pages, lengths,
            decode_attention)
        assert bf16_ulp_error(got[live], want32[live]) <= 1


def test_paged_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, kp, vp, pages, lengths = paged_case(2, 1, 2, 16, 8, 2,
                                           torch.float32, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kz.fused_paged_attention_cuda(q, kp.cpu(), vp, pages, lengths)
    with pytest.raises(ValueError, match="unsupported"):
        kz.fused_paged_attention_cuda(q[..., :12].contiguous(),
                                      kp[..., :12].contiguous(),
                                      vp[..., :12].contiguous(), pages,
                                      lengths)
    with pytest.raises(ValueError, match="unsupported"):
        kz.fused_paged_attention_cuda(q.repeat(1, 1, 5, 1), kp, vp, pages,
                                      lengths)
    with pytest.raises(TypeError, match="share a dtype"):
        kz.fused_paged_attention_cuda(q.bfloat16(), kp, vp, pages, lengths)


def test_paged_engine_on_the_card_kernels_equal_plain(cuda):
    """Smoke-size paged serving on the card, chunked prefill and shared
    prefixes on: K4 runs once a layer a decode step, and the kernels'
    run and the plain versions' run give equal greedy tokens and
    bitwise-equal energies."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import lm
    from repro_torch.serve import PagingConfig, ServeConfig, ServeEngine

    cfg = SMOKES["qwen1.5-0.5b"].with_(compute_dtype="float32")
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator().manual_seed(2)
    system = torch.randint(0, cfg.vocab, (16,), generator=g).tolist()
    prompts = [system + torch.randint(0, cfg.vocab, (int(n),),
                                      generator=g).tolist()
               for n in torch.randint(2, 20, (6,), generator=g)]
    runs = []
    for backend in ("auto", "ref"):
        eng = ServeEngine(params, cfg, ServeConfig(
            cache_len=48, power_monitor=True, kernel_backend=backend,
            paging=PagingConfig(page_size=8, num_pages=16, max_rows=3,
                                prefill_chunk=8, prefix_cache=True)))
        before = kz.fused_paged_attention_cuda.launches
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        runs.append({r.uid: r for r in eng.run()})
        launched = kz.fused_paged_attention_cuda.launches - before
        assert launched == (eng.stats["decode_steps"] * cfg.n_layers
                            if backend == "auto" else 0)
        assert eng.stats["chunk_calls"] and eng.stats["prefix_hit_requests"]
    for uid, r in runs[0].items():
        assert r.generated == runs[1][uid].generated
        assert r.power.energy == runs[1][uid].power.energy


# ------------------------------------------------- quickstart path: K5-K7
@pytest.mark.parametrize("T,L", TRANSITION_SHAPES)
def test_transitions_kernel_matches_plain(cuda, T, L):
    x = stream_words(T, L, seed=T + L)
    init = stream_words(1, L, seed=L)[0]
    before = k5.transitions_cuda.launches
    n = 0
    for mask in TRANSITION_MASKS:
        for i in (None, init):
            want = ref5.transitions_ref(x, mask, i)
            for words in (x, x.to(torch.uint16)):
                got = k5.transitions_cuda(words, mask, i)
                n += 1
                assert torch.equal(got, want), (mask, i is None, words.dtype)
    assert k5.transitions_cuda.launches == before + n


def _transitions_cases(x, init):
    """K5 against its plain version under every mask, without and with
    ``init``, as int32 and as uint16 words."""
    for mask in TRANSITION_MASKS:
        for i in (None, init):
            want = ref5.transitions_ref(x, mask, i)
            for words in (x, x.to(torch.uint16)):
                got = k5.transitions_cuda(words, mask, i)
                assert torch.equal(got, want), (mask, i is None, words.dtype)


@pytest.mark.parametrize("T,L", TRANSITION_PLAN_EDGES, ids=str)
def test_transitions_kernel_at_the_plan_edges(cuda, T, L):
    """K5 bitwise at every edge of its plan (both routes, one block and
    clusters of up to 16, the lengthened chunks of a 4 M-cycle stream)."""
    _transitions_cases(stream_words(T, L, seed=T * 3 + L),
                       stream_words(1, L, seed=L + 1)[0])


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("L", [72, 70])
def test_transitions_every_cluster_equals_plain(cuda, cluster, L):
    """Whatever the plan, K5 is the plain counter: every cluster size, at
    every tile width of the vector route (L = 72) and on the scalar one
    (L = 70)."""
    x = stream_words(1000, L, seed=cluster)
    init = stream_words(1, L, seed=cluster + 1)[0]
    for words in (x, x.to(torch.uint16)):
        wb = words.element_size()
        for tx in k5._route(L, wb, True)[2]:
            plan = k5.split_transitions(1000, L, wb, cluster, tx=tx)
            for mask in TRANSITION_MASKS:
                for i in (None, init):
                    got = k5.transitions_cuda(words, mask, i, plan)
                    assert torch.equal(got, ref5.transitions_ref(x, mask, i))


def test_transitions_misaligned_words_take_the_scalar_route(cuda):
    """A contiguous view whose base is not 16-byte aligned, and rows whose
    pitch is not (L = 33), take the scalar route and count the same; a
    vector plan forced onto the unaligned base is refused by the C entry,
    not run."""
    base = stream_words(1, 600 * 64 + 8, seed=9)[0]
    for words in (base, base.to(torch.uint16)):
        x = words[1:1 + 600 * 64].view(600, 64)
        assert x.data_ptr() % 16 and x.is_contiguous()
        assert k5.transitions_plan(600, 64, x.element_size(),
                                   False).route == "scalar"
        want = ref5.transitions_ref(x.to(torch.int32), 0x7F)
        assert torch.equal(k5.transitions_cuda(x, 0x7F), want)
        vector = k5.transitions_plan(600, 64, x.element_size())
        assert vector.route == "vector"
        with pytest.raises(RuntimeError, match="launch failed"):
            k5.transitions_cuda(x, 0x7F, plan=vector)
    x = stream_words(300, 33, seed=10)
    assert k5.transitions_plan(300, 33, 2).route == "scalar"
    assert torch.equal(k5.transitions_cuda(x.to(torch.uint16)),
                       ref5.transitions_ref(x))


@pytest.mark.parametrize("T,L", BIC_SHAPES)
def test_bic_encode_kernel_matches_plain(cuda, T, L):
    x = stream_words(T, L, seed=T * L)
    for mask in BIC_MASKS:
        for words in (x, x.to(torch.uint16)):
            tx, inv = k6.bic_encode_cuda(words, mask)
            want_tx, want_inv = ref6.bic_encode_ref(words, mask)
            assert tx.dtype == words.dtype and inv.dtype == torch.bool
            assert torch.equal(tx, want_tx) and torch.equal(inv, want_inv)
            dec = bic.bic_decode(tx, inv[:, None, :], (mask,))
            assert torch.equal(dec, x)


@pytest.mark.parametrize("L", [1, 33])
@pytest.mark.parametrize("T", PLAN_EDGES)
def test_bic_encode_at_the_plan_edges(cuda, T, L):
    """K6 at every stream length of ``PLAN_EDGES``, every mask of
    ``BIC_MASKS``, int32 and uint16 words; the output decodes back."""
    x = stream_words(T, L, seed=T * 5 + L)
    for mask in BIC_MASKS:
        for words in (x, x.to(torch.uint16)):
            tx, inv = k6.bic_encode_cuda(words, mask)
            want_tx, want_inv = ref6.bic_encode_ref(words, mask)
            assert torch.equal(tx, want_tx) and torch.equal(inv, want_inv)
            assert torch.equal(bic.bic_decode(tx, inv[:, None, :], (mask,)),
                               x)


@pytest.mark.parametrize("chunks", [1, 2, 4, 8, 16, 32, 64, 128])
def test_bic_encode_every_route_equals_plain(cuda, chunks):
    """Whatever the plan, K6 is the plain encoder: every chunk count."""
    x = stream_words(1000, 70, seed=chunks)
    plan = k1.split_plan(1, 1000, 70, chunks)
    for mask in BIC_MASKS:
        tx, inv = k6.bic_encode_cuda(x, mask, plan)
        want_tx, want_inv = ref6.bic_encode_ref(x, mask)
        assert torch.equal(tx, want_tx) and torch.equal(inv, want_inv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", TILED_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-b{c[3]}.{c[4]}.{c[5]}"
                              f"-{c[7] or c[6]}" for c in TILED_CASES])
def test_zvg_tiled_kernel_matches_plain(cuda, case, dtype):
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    M, K, N, bm, bn, bk, zf, plant = case
    a, b = tiled_case(M, K, N, zf, plant, dtype, seed=M + K)
    before = kz.zvg_matmul_cuda.launches
    out, gated = kz.zvg_matmul_cuda(a, b, bm, bn, bk)
    assert kz.zvg_matmul_cuda.launches == before + 1
    want, want_gated = zref.zvg_matmul_ref(a, b, bm, bk)
    torch.cuda.synchronize()
    assert torch.equal(gated, want_gated)
    assert tiled_error(out, want) <= TILED_TOL[dtype]


@pytest.mark.parametrize("M,K,N,bm,bk", [
    (49, 4608, 512, 128, 128),       # s4b1.c2: split 12 ways in a cluster
    (12544, 147, 64, 128, 128),      # the stem: padded for TMA
    (192, 320, 192, 64, 16),         # the smallest blocks: kS = 16
    (192, 320, 192, 64, 32)], ids=str)
def test_zvg_tiled_kernel_on_site_shapes(cuda, M, K, N, bm, bk):
    a, b = tiled_case(M, K, N, 0.5, None, torch.bfloat16, seed=M + K)
    before = kz.zvg_matmul_cuda.launches
    out, gated = kz.zvg_matmul_cuda(a, b, bm, 128, bk)
    assert kz.zvg_matmul_cuda.launches == before + 1
    want, want_gated = zref.zvg_matmul_ref(a, b, bm, bk)
    torch.cuda.synchronize()
    assert torch.equal(gated, want_gated)
    assert tiled_error(out, want) <= TILED_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("M,K,N,bm,bk", [
    (70, 90, 40, 32, 8), (200, 130, 24, 96, 24), (230, 150, 33, 200, 40),
    (49, 1152, 256, 32, 8)], ids=str)
def test_zvg_tiled_kernel_at_any_blocks(cuda, M, K, N, bm, bk, dtype):
    """Blocks that are not multiples of the card's row tile or k stage,
    zero tiles planted: the map equal to the plain version's, the product
    within the tolerance; the last case splits K across a cluster."""
    a, b = tiled_case(M, K, N, 0.5, None, dtype, seed=M + bk)
    a[:bm, :bk] = 0
    a[bm:2 * bm, 2 * bk:3 * bk] = -0.0
    before = kz.zvg_matmul_cuda.launches
    out, gated = kz.zvg_matmul_cuda(a, b, bm, 128, bk)
    assert kz.zvg_matmul_cuda.launches == before + 1
    want, want_gated = zref.zvg_matmul_ref(a, b, bm, bk)
    torch.cuda.synchronize()
    assert torch.equal(gated, want_gated)
    assert tiled_error(out, want) <= TILED_TOL[dtype]


def test_zvg_tiled_split_with_every_tile_gated_writes_plus_zero(cuda):
    """A split product whose every tile is zero (-0.0 among them) skips
    every stage of every split and writes +0.0, bit for bit."""
    a = torch.zeros(49, 1152, dtype=torch.bfloat16, device="cuda")
    a[:, 128:256] = -0.0
    b = torch.randn(1152, 256, device="cuda").to(torch.bfloat16)
    assert kz.tiled_plan(49, 1152, 256, 128, 128).splits > 1
    out, gated = kz.zvg_matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert bool((gated == 1).all())
    assert not out.view(torch.int32).any()


def _pair_operands(M, K, N, xdt, wdt, dead, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    w = torch.randn(K, N, generator=g) * K ** -0.5
    x[list(dead)] = 0.0
    if M > 2:
        x[2] = -0.0                  # live: its bits are not all zero
    return x.to(xdt).cuda(), w.to(wdt).cuda()


@pytest.mark.parametrize("xdt,wdt", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)],
    ids=["bf16-bf16", "bf16-f32", "f32-bf16", "f32-f32"])
@pytest.mark.parametrize("M,K,N,dead", [
    (8, 1024, 1024, (1, 3, 6)),      # dead rows among live ones, 8 rows
    (8, 2816, 1024, (0, 7)),         # ffn down, split 16 ways
    (9, 300, 129, (4, 8)),           # two passes of rows
    (4, 1024, 151936, (3,))], ids=str)   # the lm head, unsplit
def test_gated_row_matmul_rows_passes_and_dtype_pairs(cuda, M, K, N, dead,
                                                      xdt, wdt):
    x, w = _pair_operands(M, K, N, xdt, wdt, dead, seed=M + K + N)
    before = kz.gated_row_matmul_cuda.launches
    got = kz.gated_row_matmul_cuda(x, w)
    assert kz.gated_row_matmul_cuda.launches == before + 1
    plain = zref.gated_row_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert got.dtype == plain.dtype and got.shape == (M, N)
    assert not got[list(dead)].float().view(torch.int32).any()
    _assert_product(got, plain, x, w)


def test_stream_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = stream_words(16, 8, seed=0)
    for fn in (lambda w: k5.transitions_cuda(w),
               lambda w: k6.bic_encode_cuda(w, 0x7F)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x.cpu())
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.t())
        with pytest.raises(TypeError, match="uint16 or int32"):
            fn(x.to(torch.int64))
    for mask in (0, 0x10000):
        with pytest.raises(ValueError, match="16-bit word"):
            k6.bic_encode_cuda(x, mask)
    a, b = tiled_case(64, 64, 64, 0.5, None, torch.float32, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kz.zvg_matmul_cuda(a.cpu(), b.cpu())
    # block_m = 32 is taken, as the JAX package takes it
    out, gated = kz.zvg_matmul_cuda(a, b, block_m=32)
    want, want_gated = zref.zvg_matmul_ref(a, b, 32, 128)
    torch.cuda.synchronize()
    assert torch.equal(gated, want_gated)
    assert tiled_error(out, want) <= TILED_TOL[torch.float32]
    with pytest.raises(TypeError, match="share a dtype"):
        kz.zvg_matmul_cuda(a, b.to(torch.bfloat16))


def test_quickstart_on_the_card_kernels_equal_plain(cuda):
    from repro_torch.apps import quickstart

    counted = (k1.fused_counters_cuda, k5.transitions_cuda,
               k6.bic_encode_cuda, kz.zvg_matmul_cuda)
    before = [fn.launches for fn in counted]
    got = quickstart.run("cuda")
    assert [fn.launches - b for fn, b in zip(counted, before)] == [4, 2, 1, 1]
    want = quickstart.run("cuda", backend="ref")
    assert [fn.launches - b for fn, b in zip(counted, before)] == [4, 2, 1, 1]
    assert (got["t_raw"], got["t_enc"]) == (want["t_raw"], want["t_enc"])
    assert torch.equal(got["gated"], want["gated"])
    assert tiled_error(got["out"], want["out"]) <= TILED_TOL[torch.bfloat16]
    g, w = quickstart.lines(got), quickstart.lines(want)
    assert g[:4] == w[:4] and g[5] == w[5]
