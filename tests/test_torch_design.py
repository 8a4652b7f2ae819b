"""The port's SA coding menu, design pricing and selection against the
JAX package, on the same numpy operands.

Menu counters are sums of integer counts, exact in float32 in both
packages, so they must be equal. Every other float is float32 arithmetic
in the JAX package's operation order and must agree within rtol 1e-6; a
batch sum is taken in another order (float64 here), which stays well
inside that.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import design as JD
from repro.core import systolic as j_systolic
from repro_torch import design as D
from repro_torch.core import bic, systolic

from test_design import GOLDEN_DEFAULT

RTOL = 1e-6
MENU = tuple(bic.NAMED_SEGMENTS.values())


def _layer(zf=0.5, m=48, k=256, n=32, seed=0, relu=True, batch=None):
    """The JAX design suite's operand recipe (optionally batched)."""
    rng = np.random.default_rng(seed)
    shape_a = (m, k) if batch is None else (batch, m, k)
    shape_w = (k, n) if batch is None else (batch, k, n)
    A = rng.standard_normal(shape_a).astype(np.float32)
    if relu:
        A = np.abs(A)
    A = np.where(rng.random(A.shape) < zf, 0.0, A).astype(np.float32)
    W = (rng.standard_normal(shape_w) * 0.05).astype(np.float32)
    return A, W


def _close(got, want, ctx):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               err_msg=ctx)


def _assert_energies(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        for comp, v in w["energy"].items():
            _close(g["energy"][comp], v, f"{name}/{comp}")
        for k in ("h", "v", "cycles", "zero_fraction"):
            _close(g[k], w[k], f"{name}/{k}")


def _custom_designs():
    return (
        D.DesignPoint("both-zvg", west=D.ZVG, north=D.BIC(zvg=True)),
        D.DesignPoint("north-zvg", north=D.ZVG),
        D.DesignPoint("west-bic", west=D.BIC(bic.MANT_EXP)),
        D.DesignPoint("approx", west=D.ZVG, north=D.BIC(),
                      approx=D.ApproxPE(0.3, 0.01)),
    )


def _jax_designs(designs):
    """The same designs built from the JAX package's classes."""
    def coding(c):
        return JD.Coding(bic=c.bic, zvg=c.zvg)
    out = []
    for d in designs:
        geom = j_systolic.SAGeometry(d.geometry.rows, d.geometry.cols)
        approx = (None if d.approx is None
                  else JD.ApproxPE(d.approx.mult_discount,
                                   d.approx.rel_rms_error))
        out.append(JD.DesignPoint(d.name, west=coding(d.west),
                                  north=coding(d.north), geometry=geom,
                                  precision=d.precision, approx=approx))
    return tuple(out)


# ------------------------------------------------------------------- menu
@pytest.mark.parametrize("precision", ["bf16", "fp8e4m3", "int8"])
@pytest.mark.parametrize("geom", [(16, 16), (8, 32)])
def test_sa_design_report_key_for_key(precision, geom):
    A, W = _layer(zf=0.6, m=37, k=96, n=21, seed=len(precision))
    if precision == "bf16":
        west = north = MENU
    else:
        from repro_torch.core import precision as prec
        west = north = tuple(prec.get(precision).segments.values())
    kw = dict(west_bic=west, north_bic=north, west_zvg=True, north_zvg=True,
              precision=precision)
    want = j_systolic.sa_design_report(
        jnp.asarray(A), jnp.asarray(W), j_systolic.SAGeometry(*geom), **kw)
    got = systolic.sa_design_report(torch.from_numpy(A), torch.from_numpy(W),
                                    systolic.SAGeometry(*geom), **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith(("w_", "n_")):      # integer counter sums: exact
            assert float(got[k]) == float(v), k
        else:
            _close(got[k], v, k)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_edge_streams_are_the_jax_words(precision):
    """West words [K, M'] and North words [K, N'], zero-padded to the
    array, equal the JAX package's quantized words; on the CPU they are
    contiguous int32 for the plain version (uint16 only on the card)."""
    from repro.core import precision as j_prec
    A, W = _layer(zf=0.6, m=37, k=96, n=21, seed=5)
    a_bits, b_bits = systolic.edge_streams(
        torch.from_numpy(A), torch.from_numpy(W), precision=precision)
    assert a_bits.dtype == b_bits.dtype == torch.int32
    assert a_bits.is_contiguous() and b_bits.is_contiguous()
    assert tuple(a_bits.shape) == (96, 48) and tuple(b_bits.shape) == (96, 32)
    ja = np.asarray(j_prec.quantize_bits(jnp.asarray(A), precision), np.int32)
    jw = np.asarray(j_prec.quantize_bits(jnp.asarray(W), precision), np.int32)
    np.testing.assert_array_equal(a_bits[:, :37].numpy(), ja.T)
    np.testing.assert_array_equal(b_bits[:, :21].numpy(), jw)
    assert not a_bits[:, 37:].any() and not b_bits[:, 21:].any()


def test_golden_paper_pair_numbers():
    """The JAX package's recorded baseline/proposed energies (fJ)."""
    for kw, bt, pt, bs, ps, oh in GOLDEN_DEFAULT:
        A, W = _layer(**kw)
        ev = D.evaluate_operands(torch.from_numpy(A), torch.from_numpy(W),
                                 D.PAPER_PAIR)
        for got, want in ((ev["baseline"]["energy"]["total"], bt),
                          (ev["proposed"]["energy"]["total"], pt),
                          (ev["baseline"]["energy"]["streaming"], bs),
                          (ev["proposed"]["energy"]["streaming"], ps),
                          (ev["proposed"]["energy"]["overhead"], oh)):
            _close(got, want, str(kw))


# ----------------------------------------------------------------- pricing
@pytest.mark.parametrize("zf,seed", [(0.0, 1), (0.5, 2), (0.95, 3)])
def test_evaluate_operands_named_and_custom(zf, seed):
    A, W = _layer(zf=zf, m=40, k=128, n=24, seed=seed)
    designs = tuple(D.named_designs().values()) + _custom_designs()
    want = JD.evaluate_operands(jnp.asarray(A), jnp.asarray(W),
                                _jax_designs(designs))
    got = D.evaluate_operands(torch.from_numpy(A), torch.from_numpy(W),
                              designs)
    _assert_energies(got, want)
    sg, sw = D.savings(got), JD.savings(want)
    for name in sw:
        for k in sw[name]:
            _close(sg[name][k], sw[name][k], f"{name}/{k}")


def test_evaluate_operands_mixed_geometry_and_precision():
    A, W = _layer(zf=0.3, m=20, k=64, n=20, seed=9)
    designs = (
        D.PAPER_BASELINE,
        D.DesignPoint("mxu", west=D.ZVG, north=D.BIC(),
                      geometry=systolic.MXU_SA),
        D.DesignPoint("fp8", west=D.ZVG, north=D.BIC((0x0007,)),
                      precision="fp8e4m3"),
        D.DesignPoint("int8", west=D.ZVG, north=D.BIC((0x007F,)),
                      precision="int8"),
    )
    want = JD.evaluate_operands(jnp.asarray(A), jnp.asarray(W),
                                _jax_designs(designs))
    got = D.evaluate_operands(torch.from_numpy(A), torch.from_numpy(W),
                              designs)
    _assert_energies(got, want)
    assert D.menu_args(designs).keys() == {
        (systolic.SAGeometry(g.rows, g.cols), p)
        for (g, p) in JD.menu_args(_jax_designs(designs))}


@pytest.mark.parametrize("weighted", [False, True])
def test_evaluate_batched(weighted):
    """Depthwise-shaped problems: [B, M, 9] x [B, 9, 1], one counter pass
    per edge for the batch."""
    A3, W3 = _layer(zf=0.4, m=30, k=9, n=1, seed=4, batch=6)
    designs = tuple(D.named_designs().values())
    wts = (np.linspace(0.5, 3.0, 6).astype(np.float32) if weighted
           else None)
    want = JD.evaluate_batched(
        jnp.asarray(A3), jnp.asarray(W3), _jax_designs(designs),
        weights=None if wts is None else jnp.asarray(wts))
    got = D.evaluate_batched(
        torch.from_numpy(A3), torch.from_numpy(W3), designs,
        weights=None if wts is None else torch.from_numpy(wts))
    _assert_energies(got, want)
    with pytest.raises(ValueError, match="weights must be"):
        D.evaluate_batched(torch.from_numpy(A3), torch.from_numpy(W3),
                           designs, weights=torch.ones(5))


def test_evaluate_batched_int8_scales_per_problem():
    A3, W3 = _layer(zf=0.2, m=18, k=9, n=3, seed=8, batch=3)
    A3[1] *= 40.0                       # a different absmax per problem
    designs = (D.DesignPoint("b", precision="int8"),
               D.DesignPoint("p", west=D.ZVG, north=D.BIC((0x007F,)),
                             precision="int8"))
    want = JD.evaluate_batched(jnp.asarray(A3), jnp.asarray(W3),
                               _jax_designs(designs))
    got = D.evaluate_batched(torch.from_numpy(A3), torch.from_numpy(W3),
                             designs)
    _assert_energies(got, want)


# --------------------------------------------------------------- selection
def test_select_sites_swap_deltas_pareto():
    designs = tuple(D.named_designs().values())
    site_t, site_j = {}, {}
    for i, zf in enumerate((0.0, 0.3, 0.7, 0.9)):
        A, W = _layer(zf=zf, m=24 + i, k=48 + 16 * i, n=20, seed=20 + i,
                      relu=i % 2 == 0)
        et = D.evaluate_operands(torch.from_numpy(A), torch.from_numpy(W),
                                 designs)
        ej = JD.evaluate_operands(jnp.asarray(A), jnp.asarray(W),
                                  _jax_designs(designs))
        site_t[f"s{i}"] = {n: {k: float(v) for k, v in r["energy"].items()}
                           for n, r in et.items()}
        site_j[f"s{i}"] = {n: {k: float(v) for k, v in r["energy"].items()}
                           for n, r in ej.items()}
    st, sj = D.select_sites(site_t), JD.select_sites(site_j)
    assert st.choices == sj.choices
    assert st.changed == sj.changed
    _close(st.saving_total, sj.saving_total, "saving_total")
    _close(st.saving_primary, sj.saving_primary, "saving_primary")
    assert st.summary().keys() == sj.summary().keys()
    flips = {s: "baseline" for s in st.choices}
    dt = D.swap_deltas(site_t, st.choices, flips)
    dj = JD.select.swap_deltas(site_j, sj.choices, flips)
    assert dt.keys() == dj.keys()
    for s in dt:
        _close(dt[s], dj[s], s)
    pts = [(site_t["s1"][n]["total"], d.accuracy_proxy)
           for n, d in D.named_designs().items()]
    pts += [(1.0, 0.5), (1.0, 0.5), (2.0, 0.0), (0.5, 0.9)]
    assert D.pareto_front(pts) == JD.pareto_front(pts)


# ------------------------------------------------------------ design spec
def test_design_points_match_the_jax_menu():
    for name, d in D.named_designs().items():
        j = JD.named_designs()[name]
        assert d.label == j.label
        assert d.accuracy_proxy == j.accuracy_proxy
        assert (dataclasses.asdict(d.priced_energy())
                == dataclasses.asdict(j.priced_energy()))
    for d, j in zip(_custom_designs(), _jax_designs(_custom_designs())):
        assert d.label == j.label
        assert d.accuracy_proxy == j.accuracy_proxy
        assert (dataclasses.asdict(d.priced_energy())
                == dataclasses.asdict(j.priced_energy()))


def test_design_point_validation():
    for bad in ("has/slash", "", "a b", "x,y", "tab\t"):
        with pytest.raises(ValueError):
            D.DesignPoint(bad)
    with pytest.raises(ValueError):
        D.Coding(bic=())
    with pytest.raises(ValueError, match="unknown precision"):
        D.DesignPoint("x", precision="fp4")
    with pytest.raises(ValueError, match="mult_discount"):
        D.ApproxPE(mult_discount=1.0)
    with pytest.raises(ValueError, match="duplicate"):
        D.resolve_designs(["baseline", "baseline"])
    with pytest.raises(ValueError, match="unknown design"):
        D.resolve_designs(["nope"])
    A, W = _layer(m=16, k=32, n=16)
    with pytest.raises(ValueError, match="duplicate"):
        D.evaluate_operands(torch.from_numpy(A), torch.from_numpy(W),
                            (D.PAPER_BASELINE, D.PAPER_BASELINE))
    with pytest.raises(ValueError, match="geometries"):
        D.evaluate({}, (D.PAPER_BASELINE,
                        D.DesignPoint("m", geometry=systolic.MXU_SA)))
