"""The port's paper drivers (``repro_torch.bench``) against the live JAX
drivers (``benchmarks/``) on the CPU, on the same inputs.

The CNN drivers (C3-C5) print from one cached analysis per net; here
both packages' drivers are fed the analysis of the same operands --
ResNet50 and MobileNetV1 at 32 px, 1 image, the port's forward on the
JAX package's numpy weights and images, its ``(A, W)`` pairs priced by
each package's ``analyze_trace`` (the paper pair) --
through each driver module's ``analyze_cached`` name. Their printed
rows must then match: names and derived columns equal, the timing
column aside, every number within rtol 1e-6. The rest hold the drivers'
own computations to the JAX package's: histogram counts and counters
bitwise, energies and savings within rtol 1e-6, the same verdicts.
"""
import json
import math
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import design as JD
from repro.apps.cnn import analysis as JA
from repro.apps.cnn import nets as JN
from repro.configs import SMOKES as JSMOKES
from repro.core import activity as jactivity
from repro.core import monitor as jmonitor
from repro.core import power as jpower
from repro.core import systolic as jsystolic
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.layers import is_param
from repro_torch.apps.cnn import analysis, nets
from repro_torch.bench import (activity_reduction, bic_variants,
                               counter_kernels, fig2_distributions,
                               fig45_per_layer, overall_savings,
                               overhead_scaling, power_monitor_lm)
from repro_torch.configs import SMOKES
from repro_torch.models import convert

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

RES = 32
RTOL = 1e-6
NETS = ("resnet50", "mobilenet")
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\d+)(?:e[-+]?\d+)?")
_ROW = re.compile(r"(.*?),(-?[\d.]+|nan),(.*)$")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(tree):
    """A tree as the drivers' cache hands it back (JSON, floats)."""
    return json.loads(json.dumps(tree, default=float))


@pytest.fixture(scope="module")
def analyses():
    """``{net: (JAX analysis, port analysis)}`` of the same operands (the
    port's forward on the JAX package's numpy weights and images), each
    in ``analyze_cached``'s shape."""
    out = {}
    images = nets.synthetic_images(1, res=RES, seed=7)
    for net in NETS:
        traces = nets.forward_with_traces(net, images, seed=0)
        pl = [analysis.analyze_trace(t) for t in traces]
        jl = [JA.analyze_trace(JN.LayerTrace(
            t.name, t.kind, *(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                              for x in (t.A, t.W)), t.macs))
            for t in traces]
        out[net] = tuple(
            _json({"layers": [vars(l) for l in ls],
                   "summary": mod.network_summary(ls)})
            for ls, mod in ((jl, JA), (pl, analysis)))
    return out


def _feed(monkeypatch, analyses, jmod, pmod):
    monkeypatch.setattr(jmod, "analyze_cached",
                        lambda net, n_images=1: analyses[net][0])
    monkeypatch.setattr(pmod, "analyze_cached",
                        lambda net, **kw: analyses[net][1])


def _row(line: str) -> tuple[str, str, str]:
    """``(name, us_per_call, derived)`` of a CSV row (a name may hold a
    comma: ``fig2_<net>_weights_in_[-1,1]``)."""
    return _ROW.match(line).groups()


def _capture(capsys, fn, *args, **kw):
    fn(*args, **kw)
    return capsys.readouterr().out.splitlines()


def _same_line(got: str, want: str) -> None:
    """A row (timing column aside) or a comment line: the same text with
    every number within rtol 1e-6."""
    if not want.startswith("#"):
        gname, _, got = _row(got)
        wname, _, want = _row(want)
        assert gname == wname
    assert _NUM.sub("#", got) == _NUM.sub("#", want), (got, want)
    for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
        assert math.isclose(float(g), float(w), rel_tol=RTOL), (got, want)


def _same_output(got: list[str], want: list[str]) -> None:
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        _same_line(g, w)


def test_analyses_agree(analyses):
    for net in NETS:
        jd, pd = analyses[net]
        for k, v in jd["summary"].items():
            assert math.isclose(pd["summary"][k], v, rel_tol=RTOL), (net, k)
        for jl, pl in zip(jd["layers"], pd["layers"]):
            assert pl["name"] == jl["name"]
            for f in ("zero_fraction", "power_base", "power_prop"):
                np.testing.assert_allclose(pl[f], jl[f], rtol=RTOL)
            # a layer's saving is 1 - (ratio of two energies), so its
            # absolute error is bounded by the energies' relative one
            for f in ("activity_reduction", "saving_total"):
                np.testing.assert_allclose(pl[f], jl[f], atol=RTOL, rtol=0)


# ------------------------------------------------------------- C3, C4, C5
def test_overall_savings_rows(analyses, monkeypatch, capsys):
    from benchmarks import overall_savings as j
    _feed(monkeypatch, analyses, j, overall_savings)
    want = _capture(capsys, j.main)
    got = _capture(capsys, overall_savings.main, device="cpu")
    _same_output(got, want)
    assert any("ordering ResNet50 > MobileNet" in l for l in got)


def test_fig45_per_layer_rows(analyses, monkeypatch, capsys):
    from benchmarks import fig45_per_layer as j
    _feed(monkeypatch, analyses, j, fig45_per_layer)
    want = []
    for net in NETS:
        want += _capture(capsys, j.run_net, net)
    got = _capture(capsys, fig45_per_layer.main, device="cpu")
    _same_output(got, want)
    assert sum("C4 correlation" in l for l in got) == 2
    one = _capture(capsys, fig45_per_layer.main, net="mobilenet",
                   device="cpu")
    assert one == got[len(got) - len(one):]


def test_activity_reduction_claim_rows(analyses, monkeypatch, capsys):
    from benchmarks import activity_reduction as j
    _feed(monkeypatch, analyses, j, activity_reduction)
    want = _capture(capsys, j.main)
    got = _capture(capsys, activity_reduction.main, device="cpu")
    _same_output(got[:4], want[:4])
    assert "C3: mean streaming-activity reduction" in got[3]
    # without the card no plain version runs under a kernel's name
    kernels = [_row(l) for l in got[4:]]
    assert [r[0] for r in kernels] == [
        "transitions_ref_jnp", "transitions_cuda", "bic_encode_ref_scan",
        "bic_encode_cuda", "zvg_matmul_ref_jnp", "zvg_matmul_cuda"]
    for name, us, derived in kernels[1::2]:
        assert us == "nan" and "needs the card" in derived, name


# --------------------------------------------------------------------- C1
@pytest.mark.parametrize("net", NETS)
def test_fig2_histograms_bitwise(net, capsys):
    """Fig. 2's histograms bitwise, edges included (fault 11: XLA forms
    ``linspace`` with a reciprocal and a fused multiply-add)."""
    ws = JN.init_weights(JN.NETS[net]())
    allw = jnp.concatenate([w.reshape(-1) for w in ws.values()])
    want = jactivity.field_histograms(allw)
    got = fig2_distributions.run_net(net, device="cpu")
    for k in ("exp_counts", "mant_counts", "value_counts"):
        np.testing.assert_array_equal(got["hist"][k].numpy(),
                                      np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["hist"]["value_edges"].numpy(),
                                  np.asarray(want["value_edges"]))
    exp_conc = float(jactivity.concentration(want["exp_counts"]))
    mant_conc = float(jactivity.concentration(want["mant_counts"]))
    within = float(jnp.mean((jnp.abs(allw) <= 1.0).astype(jnp.float32)))
    for k, v in (("exp_conc", exp_conc), ("mant_conc", mant_conc),
                 ("within_pm1", within)):
        assert math.isclose(got[k], v, rel_tol=RTOL), k
    lines = capsys.readouterr().out.splitlines()
    assert [(r[0], r[2]) for r in map(_row, lines[:3])] == [
        (f"fig2_{net}_exp_concentration", f"{exp_conc:.3f}"),
        (f"fig2_{net}_mant_concentration", f"{mant_conc:.3f}"),
        (f"fig2_{net}_weights_in_[-1,1]", f"{within:.3f}")]
    ok = exp_conc > 0.8 and mant_conc < 0.2
    assert lines[3].endswith("C1 " + ("CONFIRMED" if ok else "REFUTED"))


# --------------------------------------------------------------------- C2
def _close_tree(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_tree(got[k], want[k], f"{what}/{k}")
    else:
        np.testing.assert_allclose(float(got), float(np.asarray(want)),
                                   rtol=RTOL, err_msg=what)


def test_bic_variants_quick(capsys):
    from benchmarks import bic_variants as j
    want = _capture(capsys, j.main, quick=True)
    grids = bic_variants.main(quick=True, device="cpu")
    got = capsys.readouterr().out.splitlines()
    _same_output(got, want)
    assert "C2 CONFIRMED" in "".join(got)
    A, W = bic_variants.operands(quick=True)
    jev = JD.evaluate_operands(jnp.asarray(A.numpy()),
                               jnp.asarray(W.numpy()),
                               j._grid(jsystolic.PAPER_SA))
    assert list(grids) == ["paper16"]
    _close_tree(grids["paper16"],
                {n: {k: r[k] for k in ("energy", "h", "v")}
                 for n, r in jev.items()}, "paper16")


def test_overhead_scaling(capsys):
    from benchmarks import overhead_scaling as j
    want = _capture(capsys, j.main)
    got_rep = overhead_scaling.main(device="cpu")
    got = capsys.readouterr().out.splitlines()
    _same_output(got, want)
    A, W = (jnp.asarray(t.numpy()) for t in overhead_scaling.operands())
    for n in overhead_scaling.SIZES:
        pw = jpower.sa_power(jsystolic.sa_stream_report(
            A, W, jsystolic.SAGeometry(n, n)))
        _close_tree(got_rep[n][2], pw, f"{n}x{n}")


# ------------------------------------------------------------ K1 timings
def test_counter_kernels_operands_and_plain_counters():
    from benchmarks import counter_kernels as j
    A, W = counter_kernels._operands(512, 1024, 512)
    jA, jW = j._operands(512, 1024, 512)
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
    assert counter_kernels.MENUS == j.MENUS
    a, w = A[:48, :96], W[:96, :40]
    for gname, geom in counter_kernels.GEOMS.items():
        got = counter_kernels.report(a, w, geom, counter_kernels.MENUS[4],
                                     "ref")
        want = jsystolic.sa_design_report(
            jnp.asarray(a.numpy()), jnp.asarray(w.numpy()), j.GEOMS[gname],
            west_bic=j.MENUS[4], north_bic=j.MENUS[4], west_zvg=True,
            north_zvg=True, backend="ref")
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=f"{gname} {k}")


def test_counter_kernels_on_the_cpu_skips_the_kernel(capsys):
    counter_kernels.main(quick=True, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert any("kernel column is skipped" in l and "needs the card" in l
               for l in out)
    rows = [l.split(",") for l in out if not l.startswith("#")]
    assert [r[0] for r in rows] == ["counters_128x128_menu1",
                                    "counters_128x128_menu4"]
    assert all(r[1] == "nan" and "not run" in r[2] for r in rows)
    assert not any("acceptance" in l for l in out)


# ----------------------------------------------------------- LM monitor
def test_power_monitor_lm_on_the_jax_weights(capsys):
    """The JAX driver's measurements, made here on its own weights (it
    returns nothing), against the port's ``run`` on those weights."""
    def tree(p):
        return jax.tree.map(lambda q: np.asarray(q.value), p,
                            is_leaf=is_param)

    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t))

    mcfg = jmonitor.MonitorConfig(geometry=jsystolic.MXU_SA)
    rng = np.random.default_rng(0)
    params, want = {}, {}
    for name in power_monitor_lm.ARCHS:
        cfg = JSMOKES[name]
        p = jlm.init_model(jax.random.key(0), cfg)
        params[name] = convert.params_from_jax(tree(p), SMOKES[name])
        x, _ = jlm.embed_inputs(p, cfg, {"tokens": jnp.asarray(
            rng.integers(0, cfg.vocab, (2, 64)))})
        wq = jax.tree.map(lambda a: a[0], p["stack"]["groups"])[
            "b0"]["mixer"]["wq"].value
        want[name] = jmonitor.monitor_matmul(x.reshape(-1, x.shape[-1]), wq,
                                             mcfg)
    cfg = JSMOKES[power_monitor_lm.MOE_ARCH]
    mcfg2 = power_monitor_lm.moe_config()
    p = jmoe.make_moe(jax.random.key(1), cfg.d_model, mcfg2)
    xx = jnp.asarray(rng.standard_normal((2, 16, cfg.d_model)) * 0.5,
                     jnp.bfloat16)
    logits = xx.astype(jnp.float32) @ p["router"].value
    cap = max(int(16 * mcfg2.top_k * mcfg2.capacity_factor
                  / mcfg2.num_experts), 1)
    dispatch, _, _ = jmoe._topk_dispatch(logits.reshape(2, 16, -1),
                                         mcfg2.top_k, cap)
    flat = jnp.einsum("gsec,gsd->gecd", dispatch.astype(xx.dtype),
                      xx.reshape(2, 16, -1)).reshape(-1, cfg.d_model)
    want["moe_dispatch"] = {
        "zero_rows": jnp.mean((jnp.abs(flat).max(axis=1) == 0)
                              .astype(jnp.float32)),
        **jmonitor.monitor_matmul(flat, p["w_gate"].value[0], mcfg)}

    got = power_monitor_lm.run(params, tensors(tree(p)), device="cpu")
    assert set(got) == set(want)
    for name, metrics in want.items():
        assert set(got[name]) == set(metrics), name
        for k, v in metrics.items():
            if k in ("zero_fraction", "zero_rows"):
                assert got[name][k] == float(v), (name, k)
            else:
                assert math.isclose(got[name][k], float(v), rel_tol=RTOL,
                                    abs_tol=1e-12), (name, k)
    assert got["moe_dispatch"]["zero_rows"] > 0
    rows = [l.split(",")[0] for l in capsys.readouterr().out.splitlines()
            if not l.startswith("#")]
    assert rows == [f"monitor_{n}_{m}" for n in power_monitor_lm.ARCHS
                    for m in ("zero_frac", "saving")] + [
        "monitor_moe_dispatch_zero_rows", "monitor_moe_dispatch_saving"]
