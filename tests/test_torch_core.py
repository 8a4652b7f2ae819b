"""The port's bus words, stream primitives, precision formats and energy
model against the JAX package, on the same numpy inputs.

Integer results (words, counts, encoded streams, invert lines) must be
bitwise equal. Float energies are float32 in both packages with the
same operation order, so they agree within rtol 1e-6 (a few float32
roundings, eps = 1.2e-7).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import activity as j_activity
from repro.core import bic as j_bic
from repro.core import bits as j_bits
from repro.core import monitor as j_monitor
from repro.core import power as j_power
from repro.core import precision as j_prec
from repro.core import systolic as j_systolic
from repro.core import zvg as j_zvg
from repro_torch.core import (activity, bic, bits, monitor, power,
                              precision, systolic, zvg)

RTOL = 1e-6


def _words(shape, zf=0.4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
    x[rng.random(shape) < zf] = 0
    return x


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


# ----------------------------------------------------------------- words
def test_to_bits_random_f32_patterns_bitwise():
    """2,000,000 random f32 bit patterns (NaNs, infinities, subnormals
    and both zeros among them) give the JAX package's words exactly."""
    rng = np.random.default_rng(11)
    u = rng.integers(0, 1 << 32, size=2_000_000, dtype=np.uint64)
    f = u.astype(np.uint32).view(np.float32)
    want = np.asarray(j_bits.to_bits(jnp.asarray(f))).astype(np.int32)
    got = bits.to_bits(torch.from_numpy(f)).numpy()
    assert np.isnan(f).sum() > 1000           # NaNs really are exercised
    np.testing.assert_array_equal(got, want)


def test_to_bits_nan_words_keep_the_sign():
    pats = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345,
                     0x7FFFFFFF, 0x80000000, 0x00000001, 0x7F800000],
                    np.uint32)
    f = pats.view(np.float32)
    got = bits.to_bits(torch.from_numpy(f)).tolist()
    assert got[:5] == [0x7FC0, 0xFFC0, 0x7FC0, 0xFFC0, 0x7FC0]
    assert got == np.asarray(j_bits.to_bits(jnp.asarray(f))).tolist()
    # a bfloat16 input is bitcast as it is, NaN payloads included
    w = torch.tensor([0x7FFF, 0xFF81, 0x7FC0], dtype=torch.int32)
    jw = jnp.asarray(np.array([0x7FFF, 0xFF81, 0x7FC0], np.uint16))
    assert bits.to_bits(bits.from_bits(w)).tolist() == w.tolist()
    assert np.asarray(j_bits.to_bits(j_bits.from_bits(jw))).tolist() == \
        w.tolist()


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int8])
def test_to_bits_source_dtypes(dtype):
    rng = np.random.default_rng(3)
    if dtype == np.int8:
        v = rng.integers(-128, 128, size=(64, 16)).astype(np.int8)
    else:
        v = (rng.standard_normal((64, 16)) * 3).astype(dtype)
    want = np.asarray(j_bits.to_bits(jnp.asarray(v))).astype(np.int32)
    np.testing.assert_array_equal(bits.to_bits(torch.from_numpy(v)).numpy(),
                                  want)


def test_popcount_and_roundtrip_on_every_word():
    w = torch.arange(1 << 16, dtype=torch.int32)
    u = jnp.arange(1 << 16, dtype=jnp.uint16)
    np.testing.assert_array_equal(bits.popcount(w).numpy(),
                                  np.asarray(j_bits.popcount(u)))
    for m in (0xFFFF, 0x007F, 0x7F80, 0x8001):
        np.testing.assert_array_equal(
            bits.hamming(w, w.flip(0), m).numpy(),
            np.asarray(j_bits.hamming(u, u[::-1], m)))
    assert torch.equal(bits.to_bits(bits.from_bits(w)), w)


@pytest.mark.parametrize("axis", [0, 1])
def test_matrix_stream_bits(axis):
    rng = np.random.default_rng(axis)
    x = (rng.standard_normal((12, 7)) * 3).astype(np.float32)
    want = np.asarray(j_activity.matrix_stream_bits(jnp.asarray(x), axis))
    got = activity.matrix_stream_bits(torch.from_numpy(x), axis)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


# -------------------------------------------------------------- streams
@pytest.mark.parametrize("mask", [0xFFFF, 0x007F, 0x7F80, 0x8000])
@pytest.mark.parametrize("with_init", [False, True])
def test_stream_transitions(mask, with_init):
    x = _words((97, 5, 3), seed=mask)
    init = _words((5, 3), zf=0.0, seed=1) if with_init else None
    want = j_activity.stream_transitions(
        jnp.asarray(x), mask, None if init is None else jnp.asarray(init))
    got = activity.stream_transitions(
        _t(x), mask, None if init is None else _t(init))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(j_bic.NAMED_SEGMENTS))
def test_bic_encode_named_segments(name):
    assert bic.NAMED_SEGMENTS[name] == j_bic.NAMED_SEGMENTS[name]
    segs = bic.NAMED_SEGMENTS[name]
    assert bic.seg_key(segs) == j_bic.seg_key(segs)
    x = _words((83, 7), zf=0.2, seed=len(name))
    init = _words((7,), zf=0.0, seed=5)
    for i in (None, init):
        jt, ji = j_bic.bic_encode(jnp.asarray(x), segs,
                                  None if i is None else jnp.asarray(i))
        tt, ti = bic.bic_encode(_t(x), segs, None if i is None else _t(i))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_bic_encode_ties_keep_data():
    # 0x000F against a zero bus: 4 of 8 exponent bits, a tie -> no invert
    x = np.array([[0x0780], [0x7F80], [0x0000]], np.uint16)
    tx, inv = bic.bic_encode(_t(x), bic.EXPONENT_ONLY)
    jt, ji = j_bic.bic_encode(jnp.asarray(x), bic.EXPONENT_ONLY)
    assert not bool(inv[0, 0, 0])
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji))


def test_bic_rejects_bad_segments():
    with pytest.raises(ValueError, match="overlapping"):
        bic.bic_encode(_t(_words((4, 2))), (0xFF, 0x0F))
    with pytest.raises(ValueError, match="at least one"):
        bic.bic_encode(_t(_words((4, 2))), ())


@pytest.mark.parametrize("zf", [0.0, 0.5, 0.95])
def test_zero_held_stream(zf):
    x = _words((120, 6), zf=zf, seed=int(zf * 100))
    x[::7, 0] = 0x8000                              # -0.0 is zero too
    init = _words((6,), zf=0.0, seed=9)
    for i in (None, init):
        want = j_zvg.zero_held_stream(jnp.asarray(x),
                                      None if i is None else jnp.asarray(i))
        got = zvg.zero_held_stream(_t(x), None if i is None else _t(i))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(zvg.is_zero(_t(x)).numpy(),
                                  np.asarray(j_zvg.is_zero(jnp.asarray(x))))


# ------------------------------------------------------------- precision
def test_precision_registry_matches():
    assert set(precision.PRECISIONS) == set(j_prec.PRECISIONS)
    for name, p in precision.PRECISIONS.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(j_prec.get(name))
    with pytest.raises(ValueError, match="unknown precision"):
        precision.get("fp4")


@pytest.mark.parametrize("name", ["bf16", "fp8e4m3", "int8"])
def test_quantize_bits_matches(name):
    rng = np.random.default_rng(4)
    v = (rng.standard_normal((48, 40)) * 60).astype(np.float32)
    v[rng.random(v.shape) < 0.3] = 0.0
    v[0, :4] = [1000.0, -1000.0, -0.0, 1e-9]        # clamp, -0.0, underflow
    want = np.asarray(j_prec.quantize_bits(jnp.asarray(v), name))
    got = precision.quantize_bits(torch.from_numpy(v), name)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("name", ["bf16", "fp8e4m3", "int8"])
def test_scale_energy_matches(name):
    em = power.EnergyModel()
    assert dataclasses.asdict(em) == dataclasses.asdict(j_power.EnergyModel())
    got = precision.scale_energy(em, name)
    want = j_prec.scale_energy(j_power.EnergyModel(), name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "bf16":
        assert got is em


# ------------------------------------------------------------------ power
@pytest.mark.parametrize("zf,seed", [(0.5, 0), (0.0, 1), (0.85, 2)])
def test_sa_power_paper_pair_matches(zf, seed):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.standard_normal((40, 96))).astype(np.float32)
    A[rng.random(A.shape) < zf] = 0.0
    W = (rng.standard_normal((96, 24)) * 0.05).astype(np.float32)
    jrep = j_systolic.sa_stream_report(jnp.asarray(A), jnp.asarray(W))
    trep = systolic.sa_stream_report(torch.from_numpy(A), torch.from_numpy(W))
    assert set(trep) == set(jrep)
    for k in jrep:
        np.testing.assert_allclose(float(trep[k]), float(jrep[k]),
                                   rtol=RTOL, err_msg=k)
    jp, tp = j_power.sa_power(jrep), power.sa_power(trep)
    for design in ("baseline", "proposed"):
        for k in j_power.COMPONENTS + ("total",):
            np.testing.assert_allclose(float(tp[design][k]),
                                       float(jp[design][k]), rtol=RTOL,
                                       err_msg=f"{design}/{k}")
    for k in ("saving_total", "saving_streaming", "streaming_share_base"):
        np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=RTOL)
    np.testing.assert_allclose(
        float(systolic.streaming_activity_reduction(trep)),
        float(j_systolic.streaming_activity_reduction(jrep)), rtol=RTOL)
    agg_t = power.aggregate_savings([tp, tp])
    agg_j = j_power.aggregate_savings([jp, jp])
    for k in agg_j:
        np.testing.assert_allclose(agg_t[k], agg_j[k], rtol=RTOL)


def test_geometry_validation():
    assert systolic.SAGeometry(16, 16) == systolic.PAPER_SA
    with pytest.raises(ValueError, match="rows >= 1"):
        systolic.SAGeometry(0, 16)


# ------------------------------------------------- fields and constants
def test_bit_constants_and_segments_match():
    for name in ("BF16_BITS", "SIGN_SHIFT", "EXP_SHIFT", "EXP_BIAS"):
        assert getattr(bits, name) == getattr(j_bits, name), name
    for name in ("SIGN_MASK", "EXP_MASK", "MANT_MASK", "FULL_MASK"):
        assert getattr(bits, name) == int(getattr(j_bits, name)), name
    assert bits.SEGMENTS == j_bits.SEGMENTS


def test_fields_on_every_word():
    w = torch.arange(1 << 16, dtype=torch.int32)
    u = jnp.arange(1 << 16, dtype=jnp.uint16)
    for name in ("exponent_field", "mantissa_field", "sign_field"):
        got = getattr(bits, name)(w)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(j_bits, name)(u)), err_msg=name)
    # uint16 words give the same fields
    u16 = w.to(torch.uint16)
    assert torch.equal(bits.exponent_field(u16), bits.exponent_field(w))


# ------------------------------------------------------------- ZVG report
@pytest.mark.parametrize("zf", [0.0, 0.5, 0.95])
@pytest.mark.parametrize("with_init", [False, True])
def test_zvg_stream_report(zf, with_init):
    x = _words((90, 5), zf=zf, seed=int(zf * 10) + with_init)
    x[::5, 1] = 0x8000                              # -0.0 is zero too
    init = _words((5,), zf=0.0, seed=8) if with_init else None
    want = j_zvg.zvg_stream_report(
        jnp.asarray(x), None if init is None else jnp.asarray(init))
    got = zvg.zvg_stream_report(_t(x), None if init is None else _t(init))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_zero_fraction_matches():
    rng = np.random.default_rng(6)
    v = rng.standard_normal((37, 29)).astype(np.float32)
    v[rng.random(v.shape) < 0.45] = 0.0
    v[0, :3] = -0.0
    got = zvg.zero_fraction(torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got),
                               float(j_zvg.zero_fraction(jnp.asarray(v))),
                               rtol=RTOL)


# --------------------------------------------------------- BIC decoding
@pytest.mark.parametrize("name", sorted(j_bic.NAMED_SEGMENTS))
def test_bic_decode_and_transitions(name):
    segs = bic.NAMED_SEGMENTS[name]
    x = _words((70, 6), zf=0.3, seed=len(name) + 20)
    init = _words((6,), zf=0.0, seed=21)
    tx, inv = bic.bic_encode(_t(x), segs)
    dec = bic.bic_decode(tx, inv, segs)
    jt, ji = j_bic.bic_encode(jnp.asarray(x), segs)
    np.testing.assert_array_equal(dec.numpy(), x.astype(np.int32))
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(j_bic.bic_decode(jt, ji, segs)))
    for i in (None, init):
        for lines in (False, True):
            want = j_bic.bic_transitions(
                jnp.asarray(x), segs, None if i is None else jnp.asarray(i),
                include_inv_lines=lines)
            got = bic.bic_transitions(_t(x), segs,
                                      None if i is None else _t(i),
                                      include_inv_lines=lines)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encode_weight_mantissas_matches():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((32, 16)) * 0.05).astype(np.float32)
    tx, inv = bic.encode_weight_mantissas(torch.from_numpy(w))
    jt, ji = j_bic.encode_weight_mantissas(jnp.asarray(w, jnp.bfloat16))
    assert tuple(tx.shape) == (32, 16) and tuple(inv.shape) == (32, 1, 16)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji))


# ------------------------------------------------------ activity helpers
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mask", [0xFFFF, 0x007F])
def test_matrix_transitions_and_activity_factor(axis, mask):
    rng = np.random.default_rng(axis + mask)
    m = (rng.standard_normal((24, 40)) * 0.3).astype(np.float32)
    m[rng.random(m.shape) < 0.3] = 0.0
    got = activity.matrix_transitions(torch.from_numpy(m), axis, mask)
    want = j_activity.matrix_transitions(jnp.asarray(m), axis, mask)
    assert got.dtype == torch.int32 and int(got) == int(want)
    np.testing.assert_allclose(
        float(activity.activity_factor(torch.from_numpy(m), axis)),
        float(j_activity.activity_factor(jnp.asarray(m), axis)), rtol=RTOL)


@pytest.mark.parametrize("bins", [64, 17])
def test_field_histograms_and_concentration(bins):
    rng = np.random.default_rng(bins)
    w = (rng.standard_normal(20000) * 0.05).astype(np.float32)
    got = activity.field_histograms(torch.from_numpy(w), bins=bins)
    want = j_activity.field_histograms(jnp.asarray(w), bins=bins)
    assert set(got) == set(want)
    for k in ("value_counts", "exp_counts", "mant_counts"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["value_edges"].numpy(),
                               np.asarray(want["value_edges"]), rtol=0,
                               atol=1e-6)
    for k in ("exp_counts", "mant_counts", "value_counts"):
        for top in (4, 8):
            np.testing.assert_allclose(
                float(activity.concentration(got[k], top)),
                float(j_activity.concentration(want[k], top)), rtol=RTOL)


def test_field_histograms_constant_input():
    # a range of zero width is widened by 0.5 each way, as in jnp
    w = np.full(50, 0.25, np.float32)
    got = activity.field_histograms(torch.from_numpy(w), bins=8)
    want = j_activity.field_histograms(jnp.asarray(w), bins=8)
    np.testing.assert_array_equal(got["value_counts"].numpy(),
                                  np.asarray(want["value_counts"]))
    np.testing.assert_allclose(got["value_edges"].numpy(),
                               np.asarray(want["value_edges"]), atol=1e-6)


# --------------------------------------------------- SA reference, monitor
def test_sa_matmul_reference_matches():
    rng = np.random.default_rng(12)
    A = rng.standard_normal((33, 70)).astype(np.float32)
    W = rng.standard_normal((70, 19)).astype(np.float32)
    got = systolic.sa_matmul_reference(torch.from_numpy(A),
                                       torch.from_numpy(W))
    want = np.asarray(j_systolic.sa_matmul_reference(jnp.asarray(A),
                                                     jnp.asarray(W)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_monitor_matmul_matches():
    rng = np.random.default_rng(13)
    acts = np.abs(rng.standard_normal((3, 40, 64))).astype(np.float32)
    acts[rng.random(acts.shape) < 0.5] = 0.0
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    kw = dict(max_rows=100, max_cols=32, max_depth=48)
    got = monitor.monitor_matmul(torch.from_numpy(acts), torch.from_numpy(w),
                                 monitor.MonitorConfig(**kw))
    want = j_monitor.monitor_matmul(jnp.asarray(acts), jnp.asarray(w),
                                    j_monitor.MonitorConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


def test_core_exports_match_the_jax_package():
    import repro.core as j_core
    import repro_torch.core as t_core
    public = {n for n in dir(j_core) if not n.startswith("_")}
    assert public <= {n for n in dir(t_core) if not n.startswith("_")}
