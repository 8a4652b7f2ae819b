"""The port's fused power-counter pass against the JAX package.

The bar is bitwise equality of every integer counter: the port's plain
PyTorch version against the JAX reference ``fused_counters_ref`` and
against the Pallas kernel run in interpret mode, on the cases of the JAX
package's own counter harness (ragged shapes, adversarial streams, each
named segment variant, bf16 / f32 / int8 sources) plus a batch and a
31-segment spec. The Hopper kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bic as j_bic
from repro.core.bits import to_bits as j_to_bits
from repro.kernels.power_counters import CounterSpec as JSpec
from repro.kernels.power_counters.kernel import fused_counters_pallas
from repro.kernels.power_counters.ref import fused_counters_ref as j_ref
from repro_torch.core import bic
from repro_torch.kernels.power_counters import (CounterSpec, edge_counters,
                                                resolve_backend)
from repro_torch.kernels.power_counters.cases import (PLAN_EDGES,
                                                     chunk_coverage)
from repro_torch.kernels.power_counters.ref import fused_counters_ref

#: jitted so that cases of one shape and spec compile the kernel once
_pallas = jax.jit(fused_counters_pallas, static_argnames=("spec", "block_t"))

VARIANTS = tuple(bic.NAMED_SEGMENTS.values())
FULL = dict(bic_variants=VARIANTS, zvg=True, hist=True)


def _sparse(t, l, zf=0.4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=(t, l), dtype=np.uint16)
    x[rng.random((t, l)) < zf] = 0
    return x


def _port(x, spec_kw):
    c, r = fused_counters_ref(torch.from_numpy(np.asarray(x, np.int32)),
                              CounterSpec(**spec_kw))
    return c.numpy(), r.numpy()


def _assert_same(spec_kw, got, want, ctx):
    rows = CounterSpec(**spec_kw).rows
    gc, gr = got
    wc, wr = (np.asarray(v) for v in want)
    bad = [rows[i] for i in np.where(~(gc == wc).all(axis=1))[0]]
    assert not bad, f"{ctx}: rows differ: {bad}"
    np.testing.assert_array_equal(gr, wr, err_msg=f"{ctx}: rowzeros")


def _both(x, spec_kw, ctx, pallas=True, block_t=None):
    """Port vs the JAX reference and (small shapes) the Pallas kernel in
    interpret mode."""
    js = JSpec(**spec_kw)
    got = _port(x, spec_kw)
    _assert_same(spec_kw, got, j_ref(jnp.asarray(x), js), f"{ctx} vs ref")
    if pallas:
        _assert_same(spec_kw, got,
                     _pallas(jnp.asarray(x), js, block_t=block_t),
                     f"{ctx} vs pallas")


def test_rows_match_jax_spec():
    for kw in (FULL, dict(bic_variants=VARIANTS), dict(zvg=True),
               dict(bic_variants=((0x7F,),), hist=True)):
        assert CounterSpec(**kw).rows == JSpec(**kw).rows
        assert (CounterSpec(**kw).unique_segments
                == JSpec(**kw).unique_segments)
        assert CounterSpec(**kw).n_bic_states == JSpec(**kw).n_bic_states


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (257, 129), (33, 257)])
def test_shapes_full_spec(shape):
    _both(_sparse(*shape, seed=shape[0]), FULL, shape,
          pallas=shape[0] * shape[1] <= 4096)


def test_long_stream_against_reference():
    """A K = 4608 stream (ResNet50's deepest reduction) over a few lanes:
    the log-depth scans must carry across thirteen doubling steps."""
    _both(_sparse(4608, 5, zf=0.6, seed=3), FULL, "long", pallas=False)


def test_adversarial_streams():
    """Fixed worst cases, all [96, 4] like most cases here, so the JAX
    side compiles once for that shape."""
    def tile(col, reps=96):
        col = np.asarray(col, np.uint16).reshape(-1, 1)
        return np.tile(col, (reps // len(col) + 1, 4))[:reps]

    def bf16_words(vals):
        return np.asarray(j_to_bits(jnp.asarray(vals, jnp.bfloat16)))

    cases = {
        "all_zero": np.zeros((96, 4), np.uint16),
        "constant": tile([0x55AA]),
        # every cycle flips all 16 bus bits: worst for raw, best for BIC
        "alternate_inv": tile([0x0000, 0xFFFF]),
        "alt_sign": tile(bf16_words([1.0, -1.0])),
        "zero_sep": tile([0x3F80, 0x0000]),
        "neg_zero": tile(bf16_words([1.0, -0.0, 0.0, 2.0])),
        "nan_subnormal": tile([0x7FC0, 0x0001, 0xFFC0, 0x8001, 0x8000]),
    }
    for name, x in cases.items():
        _both(x, FULL, name, block_t=32)


@pytest.mark.parametrize("variant", sorted(bic.NAMED_SEGMENTS))
def test_each_named_segment_variant_alone(variant):
    kw = dict(bic_variants=(bic.NAMED_SEGMENTS[variant],), zvg=True)
    _both(_sparse(96, 4, zf=0.3, seed=len(variant)), kw, variant,
          block_t=32)


@pytest.mark.parametrize("dtype,scale", [("bf16", 1.0), ("f32", 0.02),
                                         ("int8", 1.0)])
def test_source_dtypes(dtype, scale):
    rng = np.random.default_rng(7)
    if dtype == "int8":
        v = rng.integers(-128, 128, size=(96, 4)).astype(np.int8)
        x = v.astype(np.uint16)
    else:
        v = rng.standard_normal((96, 4)) * scale
        v[rng.random(v.shape) < 0.4] = 0.0
        x = np.asarray(j_to_bits(jnp.asarray(v, jnp.bfloat16)))
    _both(x, FULL, dtype, block_t=32)


def test_31_unique_segments():
    """The packed invert state's limit: 31 unique segments in one pass
    (16 single bits, 8 + 7 two-bit masks, three variants)."""
    variants = (tuple(1 << b for b in range(16)),
                tuple(3 << (2 * i) for i in range(8)),
                tuple(3 << (2 * i + 1) for i in range(7)))
    kw = dict(bic_variants=variants, zvg=True)
    assert len(CounterSpec(**kw).unique_segments) == 31
    _both(_sparse(90, 6, zf=0.3, seed=31), kw, "31 segments", pallas=False)
    with pytest.raises(ValueError, match="31 bit lanes"):
        CounterSpec(bic_variants=variants + ((0x8001,),))


def test_batched_equals_per_problem():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 16, size=(4, 96, 4), dtype=np.uint16)
    x[rng.random(x.shape) < 0.5] = 0
    counts, rowzeros = _port(x, FULL)
    assert counts.shape == (4, CounterSpec(**FULL).n_rows, 4)
    for b in range(4):
        _assert_same(FULL, (counts[b], rowzeros[b]),
                     j_ref(jnp.asarray(x[b]), JSpec(**FULL)), f"batch {b}")


def test_edge_counters_backends():
    x = torch.from_numpy(_sparse(96, 8, zf=0.5).astype(np.int32))
    spec = CounterSpec(**FULL)
    out = edge_counters(x, spec)
    assert set(out) == set(spec.rows) | {"rowzeros"}
    ref = edge_counters(x, spec, backend="ref")
    for k in out:
        assert torch.equal(out[k], ref[k]), k
    assert int(out["rowzeros"].sum()) == int(out["zeros"].sum())
    assert resolve_backend(None, x.device) == "ref"
    assert resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    with pytest.raises(ValueError, match="CUDA tensor"):
        edge_counters(x, spec, backend="cuda")
    with pytest.raises(ValueError, match="unknown counter backend"):
        edge_counters(x, spec, backend="pallas")


def test_counter_spec_validation():
    with pytest.raises(ValueError, match="overlapping"):
        CounterSpec(bic_variants=((0xFF, 0x0F),))
    with pytest.raises(ValueError, match="empty"):
        CounterSpec(bic_variants=((),))
    with pytest.raises(ValueError, match="duplicate"):
        CounterSpec(bic_variants=((0x7F,), (0x7F,)))
    spec = CounterSpec(bic_variants=((0x7F,),), zvg=True, hist=True)
    assert spec.rows[:3] == ("raw", "mant_raw", "zeros")
    assert spec.n_rows == 3 + 3 + 2 + 2 + 16


# ------------------------------------------------- the card kernel's plan
#: (B, T, L): ResNet50's stem west edge, its stage-4 west and north edges
#: (s4b1.c2, K = 4608), MobileNetV1's first and last depthwise batches,
#: the serving accountant's prefill edges (Qwen1.5-0.5B, K sampled to
#: 1024: 128 prompt rows west, 256 weight columns north), and edges
PLAN_SHAPES = [(1, 147, 12544), (1, 4608, 64), (1, 4608, 512),
               (32, 9, 12544), (1024, 9, 64), (1, 1024, 128),
               (1, 1024, 256), (1, 1, 1), (3, 4609, 20), (5, 33, 33),
               (7, 1025, 45), (1, 64, 3136), (65535, 1, 1)]


@pytest.mark.parametrize("B,T,L", PLAN_SHAPES, ids=str)
def test_counter_plan_covers_every_cycle_of_every_lane_once(B, T, L):
    """Every cycle of every lane of every stream of the batch lies in
    exactly one chunk; a group's chunks fit one block or a cluster of at
    most 16 (the non-portable limit the launch asks for past 8), the grid
    fits CUDA's x dimension, and the chunks cover T."""
    from repro_torch.kernels.power_counters.kernel import (WALK_MAX_CHUNKS,
                                                           WALK_MIN_CHUNK,
                                                           counter_plan)
    plan = counter_plan(B, T, L)
    assert plan.split in (1, 2, 4, 8)
    assert 1 <= plan.cluster <= WALK_MAX_CHUNKS // 8 == 16
    assert plan.cluster == 1 or plan.split == 8
    assert plan.chunks * plan.chunk >= T
    assert plan.chunks == 1 or T // plan.chunks >= WALK_MIN_CHUNK
    assert 1 <= plan.blocks <= 2 ** 31 - 1
    assert plan.blocks % plan.cluster == 0
    if B * T * L <= 4_000_000:
        assert (chunk_coverage(plan, B, T, L) == 1).all()


def test_counter_plan_routes_at_the_main_path_shapes():
    """The route and plan at the shapes the main paths launch: long
    streams over few groups split T across clusters of 16 (128 chunks of
    36 cycles at ResNet50's s4b1.c2 west edge), its north edge's 16 groups
    across clusters of 8, the stem's 392 groups across 4 warps of a block,
    the depthwise batches' 9 cycles in one pass with 8 groups a block, the
    serving prefill's K = 1024 in clusters of 16, chunks of 8."""
    from repro_torch.kernels.power_counters.kernel import counter_plan
    want = {(1, 147, 12544): ("block", 37, 4, 1, 196),
            (1, 4608, 64): ("cluster", 36, 8, 16, 32),
            (1, 4608, 512): ("cluster", 72, 8, 8, 128),
            (32, 9, 12544): ("one pass", 9, 1, 1, 1568),
            (1024, 9, 64): ("one pass", 9, 1, 1, 256),
            (1, 1024, 128): ("cluster", 8, 8, 16, 64),
            (1, 1024, 256): ("cluster", 8, 8, 16, 128)}
    for shape, (route, chunk, split, cluster, blocks) in want.items():
        p = counter_plan(*shape)
        assert (p.route, p.chunk, p.split, p.cluster, p.blocks) == (
            route, chunk, split, cluster, blocks), shape
    with pytest.raises(ValueError, match="B, T, L >= 1"):
        counter_plan(1, 0, 5)


@pytest.mark.parametrize("T", PLAN_EDGES)
def test_plain_matches_jax_at_the_plan_edges(T):
    """The plain version, which the card kernel is held to, against the
    JAX reference (and the Pallas kernel in interpret mode up to 65
    cycles) at every stream length of ``PLAN_EDGES``: one cycle, the
    shortest split and one more or less, and the block's and clusters'
    chunks and one more or less."""
    _both(_sparse(T, 5, zf=0.5, seed=T), FULL, f"T={T}", pallas=T <= 65,
          block_t=32 if T <= 65 else None)
