"""The port's CNN power-measurement slice against the JAX package, live.

One JAX run (ResNet50 at 32 px, 1 synthetic image, the 7-design menu) is
shared by the module. Two levels of agreement:

* **The slice on the same operands.** The port's ``analyze_trace`` on the
  54 ``(A, W)`` pairs the JAX forward captured: every menu counter equal,
  energies and savings within rtol 1e-6 (float32 in the same operation
  order), and all 54 per-site choices equal -- the tightest top-two gap
  of a site is a few 1e-6, so this needs the 1e-6 agreement.
* **The port's own forward** on the same images and weights: convolution
  and BN sums are taken in another order than XLA's, so activations
  agree only to float32 rounding, which batch-statistics BN amplifies
  where it normalizes over few samples (4 per channel in stage 3 at
  32 px; stage 4's single sample resets every channel to its beta). The
  bf16 operands agree within one bf16 ulp (2**-7 relative) plus atol
  0.05 on standardized activations, and within 5e-3 on average per
  layer (measured on the CPU: at most 0.033 and 2.4e-3); logits within
  atol 1e-5; per-layer zero fractions within 1e-3; ``saving_selected``
  within rtol 1e-3, and choices are equal except at sites whose JAX
  top-two gap is below 1e-4 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import design as JD
from repro.apps.cnn import analysis as JA
from repro.apps.cnn import nets as JN
from repro.core import systolic as j_systolic
from repro_torch import design as D
from repro_torch.apps.cnn import analysis, nets
from repro_torch.core import systolic

RES = 32
RTOL = 1e-6


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _top_two_gap(designs: dict) -> float:
    tot = sorted(float(r["total"]) for r in designs.values())
    return (tot[1] - tot[0]) / tot[0]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's ResNet50 analysis at 32 px, with its per-site
    menus (the same jit-cached ``sa_design_report`` calls the analysis
    makes)."""
    images = JN.synthetic_images(1, res=RES, seed=7)
    traces = JN.forward_with_traces("resnet50", images, seed=0)
    designs = tuple(JD.named_designs().values())
    layers = [JA.analyze_trace(t, designs=designs) for t in traces]
    sel = JA.select_network(layers)
    (geom, precision), kw = next(iter(JD.menu_args(designs).items()))
    menus = [j_systolic.sa_design_report(t.A, t.W, geom, backend=None,
                                         precision=precision, **kw)
             for t in traces]
    specs = JN.resnet50_specs()
    params = nets.params_from_numpy(
        {k: np.asarray(v) for k, v in JN.init_weights(specs, 0).items()},
        {k: (np.asarray(g), np.asarray(b))
         for k, (g, b) in JN.init_bn(specs, 0).items()})
    return dict(images=np.array(images), traces=traces, layers=layers,
                sel=sel, menus=menus, params=params,
                logits=np.asarray(JN.make_forward("resnet50", 0)(images)))


@pytest.fixture(scope="module")
def port_on_jax_operands(jax_run):
    traces = [nets.LayerTrace(t.name, t.kind,
                              torch.from_numpy(_np(t.A)).to(torch.bfloat16),
                              torch.from_numpy(_np(t.W)).to(torch.bfloat16),
                              t.macs)
              for t in jax_run["traces"]]
    designs = tuple(D.named_designs().values())
    layers = [analysis.analyze_trace(t, designs=designs) for t in traces]
    return traces, layers, analysis.select_network(layers)


# ------------------------------------------------------------- parameters
@pytest.mark.parametrize("net", ["resnet50", "mobilenet"])
def test_init_weights_and_bn_bitwise(net):
    specs = nets.NETS[net]()
    assert [s.name for s in specs] == [s.name for s in JN.NETS[net]()]
    jw, tw = JN.init_weights(JN.NETS[net](), 3), nets.init_weights(specs, 3)
    assert jw.keys() == tw.keys()
    for k in jw:
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))
    jb, tb = JN.init_bn(JN.NETS[net](), 3), nets.init_bn(specs, 3)
    for k in jb:
        for t, j in zip(tb[k], jb[k]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("res", [32, 64])
def test_synthetic_images_match(res):
    """Bilinear upsampling in PyTorch vs ``jax.image.resize``: the same
    half-pixel-centre weights, rounded in another order (atol 1e-5 on
    standardized images)."""
    want = np.asarray(JN.synthetic_images(2, res=res, seed=7))
    got = nets.synthetic_images(2, res=res, seed=7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------- the slice on JAX's operands
def test_slice_menus_equal_on_every_site(jax_run, port_on_jax_operands):
    traces, _, _ = port_on_jax_operands
    designs = tuple(D.named_designs().values())
    (geom, precision), kw = next(iter(D.menu_args(designs).items()))
    assert len(traces) == 54
    for t, want in zip(traces, jax_run["menus"]):
        got = systolic.sa_design_report(t.A, t.W, geom, precision=precision,
                                        **kw)
        assert set(got) == set(want), t.name
        for k, v in want.items():
            if k.startswith(("w_", "n_")):   # counter sums: exact
                assert float(got[k]) == float(v), (t.name, k)
            else:
                np.testing.assert_allclose(float(got[k]), float(v),
                                           rtol=RTOL, err_msg=k)


def test_slice_energies_and_selection(jax_run, port_on_jax_operands):
    _, layers, sel = port_on_jax_operands
    jsel = jax_run["sel"]
    for got, want in zip(layers, jax_run["layers"]):
        assert got.name == want.name and got.kind == want.kind
        for f in ("macs", "zero_fraction", "power_base", "power_prop",
                  "energy_base", "energy_prop", "streaming_share"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=RTOL, err_msg=f"{got.name}.{f}")
        # a layer's saving is 1 - (ratio of two energies), so its absolute
        # error is bounded by the energies' relative one
        for f in ("activity_reduction", "saving_total", "saving_streaming"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       atol=RTOL, rtol=0,
                                       err_msg=f"{got.name}.{f}")
        for name, r in want.designs.items():
            for k, v in r.items():
                np.testing.assert_allclose(got.designs[name][k], v,
                                           rtol=RTOL, err_msg=name)
    assert sel.choices == jsel.choices           # all 54 sites
    s, j = sel.summary(), jsel.summary()
    assert (s["n_sites"], s["n_changed"], s["designs_used"]) == \
        (j["n_sites"], j["n_changed"], j["designs_used"]) == \
        (54, 54, ["bic-west", "mant-exp"])
    np.testing.assert_allclose(s["saving_selected"], j["saving_selected"],
                               rtol=RTOL)
    np.testing.assert_allclose(s["saving_fixed"], j["saving_fixed"],
                               rtol=RTOL)
    ts, js = (analysis.network_summary(layers),
              JA.network_summary(jax_run["layers"]))
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=RTOL, err_msg=k)


def test_dwconv_site_batched_matches():
    """A depthwise site goes through the batched per-channel form."""
    rng = np.random.default_rng(12)
    M, C = 50, 24
    A = np.maximum(rng.standard_normal((M, 9 * C)), 0).astype(np.float32)
    W = (rng.standard_normal((9, C)) * 0.4).astype(np.float32)
    designs = tuple(D.named_designs().values())
    want = JA.analyze_trace(
        JN.LayerTrace("dw", "dwconv", jnp.asarray(A, jnp.bfloat16),
                      jnp.asarray(W, jnp.bfloat16), float(M * 9 * C)),
        designs=tuple(JD.named_designs().values()))
    got = analysis.analyze_trace(
        nets.LayerTrace("dw", "dwconv", torch.from_numpy(A).to(torch.bfloat16),
                        torch.from_numpy(W).to(torch.bfloat16),
                        float(M * 9 * C)),
        designs=designs)
    for name, r in want.designs.items():
        for k, v in r.items():
            np.testing.assert_allclose(got.designs[name][k], v, rtol=RTOL)
    np.testing.assert_allclose(got.zero_fraction, want.zero_fraction,
                               rtol=RTOL)


# ------------------------------------------------------- the port forward
def test_port_forward_matches(jax_run):
    images = torch.from_numpy(jax_run["images"])
    logits = nets.make_forward("resnet50",
                               params=jax_run["params"])(images)
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"], atol=1e-5,
                               rtol=0)
    traces = nets.forward_with_traces("resnet50", images,
                                      params=jax_run["params"])
    for got, want in zip(traces, jax_run["traces"]):
        assert got.name == want.name
        np.testing.assert_array_equal(got.W.float().numpy(), _np(want.W))
        ja, pa = _np(want.A), got.A.float().numpy()
        assert pa.shape == ja.shape, got.name
        np.testing.assert_allclose(pa, ja, rtol=2.0 ** -7, atol=0.05,
                                   err_msg=got.name)
        assert np.abs(pa - ja).mean() < 5e-3, got.name
        assert abs((pa == 0).mean() - (ja == 0).mean()) < 1e-3, got.name

    designs = tuple(D.named_designs().values())
    layers = [analysis.analyze_trace(t, designs=designs) for t in traces]
    sel = analysis.select_network(layers)
    jsel = jax_run["sel"]
    np.testing.assert_allclose(sel.saving_total, jsel.saving_total,
                               rtol=1e-3)
    for want in jax_run["layers"]:
        if _top_two_gap(want.designs) >= 1e-4:
            assert sel.choices[want.name] == jsel.choices[want.name]


def test_port_seed_forward_equals_imported_params(jax_run):
    """``seed`` and ``params_from_numpy`` of the JAX draws are the same
    network."""
    images = torch.from_numpy(jax_run["images"])
    a = nets.forward_with_traces("resnet50", images, seed=0)
    b = nets.forward_with_traces("resnet50", images,
                                 params=jax_run["params"])
    for x, y in zip(a, b):
        assert torch.equal(x.A, y.A) and torch.equal(x.W, y.W)


def test_analyze_network_on_cpu():
    layers = analysis.analyze_network(
        "mobilenet", n_images=1, res=RES, device="cpu",
        designs=tuple(D.named_designs().values()))
    assert [l.name for l in layers] == [s.name for s in nets.mobilenet_specs()]
    sel = analysis.select_network(layers)
    assert sel.saving_total >= sel.saving_primary
    assert all(l.selected for l in layers)
