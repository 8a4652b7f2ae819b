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
