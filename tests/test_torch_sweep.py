"""The port's design-space sweep (``repro_torch.design.sweep``), its
benchmark (``repro_torch.bench.design_sweep``) and the tracer's two CLIs
against the live JAX package, on the CPU.

Tolerances:
* the grid: equal names and coordinates;
* priced rows on the same sites: every integer and string equal, every
  float within rtol 1e-6; the same pareto front and ``beats_fixed``;
* fitted sites (``collect_sites``): equal names and weights; the port's
  fit of the JAX tracer's own site operands bitwise equal to the JAX
  package's samples at every site; the port's own forward's samples
  bitwise wherever its operands are the JAX forward's bit for bit: every
  site of the three smoke LMs (the port rounds bf16 SiLU and scalars as
  the JAX package does; the few words a float32 exp an ulp apart moves,
  in layer 1 of Qwen and Phi, fall outside these samples), and the CNN's
  weights and its stem's image (its float32 convolutions sum in another
  order, ``tests/test_torch_trace.py``).
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.trace.interpret as JI
from repro.configs import SMOKES as JSMOKES
from repro.design import sweep as JSW
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro_torch.bench import design_sweep as bench
from repro_torch.bench import trace_full_model as tfm
from repro_torch.configs import SMOKES
from repro_torch.core import precision as prec
from repro_torch.design import sweep as SW
from repro_torch.models import convert

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the JAX package's benchmarks/
    sys.path.insert(0, str(ROOT))
RTOL = 1e-6
LMS = ("qwen1.5-0.5b", "granite-3-2b", "phi3.5-moe-42b-a6.6b")
SAMPLE = (24, 24, 24)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's port code: the suite runs
    several workers on the machine's cores, and a pool of threads in each
    ran these tests 50-100x slower than alone (the quick benchmark, 5 s
    alone, took 280 s; on one thread alone it takes 7 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _rows_close(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=RTOL,
                                           err_msg=f"{w['name']} {k}")
            else:
                assert g[k] == v, (w["name"], k)


# -------------------------------------------------------------------- grid
@pytest.mark.parametrize("geoms", ["default", "quick"])
def test_sweep_grid_names_and_coordinates_equal_jax(geoms):
    geometries = {"default": SW.GEOMETRIES,
                  "quick": SW.QUICK_GEOMETRIES}[geoms]
    assert geometries == {"default": JSW.GEOMETRIES,
                          "quick": JSW.QUICK_GEOMETRIES}[geoms]
    grid = SW.sweep_grid(geometries=geometries)
    jgrid = JSW.sweep_grid(geometries=geometries)
    assert len(grid) == len(jgrid) == (320 if geoms == "default" else 240)
    for d, j in zip(grid, jgrid):
        assert d.name == j.name
        assert (d.precision, d.geometry.rows, d.geometry.cols) == (
            j.precision, j.geometry.rows, j.geometry.cols)
        for edge in ("west", "north"):
            c, jc = getattr(d, edge), getattr(j, edge)
            assert (c.bic, c.zvg) == (jc.bic, jc.zvg), (d.name, edge)
        assert (d.approx is None) == (j.approx is None)
        if d.approx is not None:
            assert (d.approx.mult_discount, d.approx.rel_rms_error) == (
                j.approx.mult_discount, j.approx.rel_rms_error)
        assert d.accuracy_proxy == pytest.approx(j.accuracy_proxy,
                                                 rel=RTOL)
    assert (SW.REFERENCE, SW.FIXED, SW.PRECISIONS) == (
        JSW.REFERENCE, JSW.FIXED, JSW.PRECISIONS)


@pytest.mark.parametrize("pname", ["bf16", "fp8e4m3", "int8"])
def test_coding_schemes_equal_jax(pname):
    from repro.core import precision as jprec
    got = SW.coding_schemes(prec.get(pname))
    want = JSW.coding_schemes(jprec.get(pname))
    assert list(got) == list(want)
    for k in want:
        assert [(c.bic, c.zvg) for c in got[k]] == [
            (c.bic, c.zvg) for c in want[k]], k


@pytest.mark.parametrize("n,target,axis", [
    (300, 96, 0), (97, 96, 1), (96, 96, 0), (40, 96, 1), (7, 96, 0),
    (1, 24, 1)])
def test_fit_axis_equals_jax(n, target, axis):
    x = np.random.default_rng(n).standard_normal(
        (n, 5) if axis == 0 else (5, n)).astype(np.float32)
    got = SW._fit_axis(torch.from_numpy(x), target, axis)
    want = JSW._fit_axis(jnp.asarray(x), target, axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ report
def _synthetic_sites():
    """``tests/test_design_sweep.py``'s synthetic sites, in both
    packages."""
    rng = np.random.default_rng(11)
    A3 = np.abs(rng.standard_normal((2, 24, 32))).astype(np.float32)
    A3[0][rng.random((24, 32)) < 0.6] = 0.0
    W3 = (rng.standard_normal((2, 32, 16)) * 0.05).astype(np.float32)
    sites = SW.SweepSites(A=torch.from_numpy(A3), W=torch.from_numpy(W3),
                          weights=torch.tensor([4.0, 1.0]),
                          names=["s0", "s1"], sample=(24, 32, 16))
    jsites = JSW.SweepSites(A=jnp.asarray(A3), W=jnp.asarray(W3),
                            weights=jnp.asarray([4.0, 1.0], jnp.float32),
                            names=["s0", "s1"], sample=(24, 32, 16))
    return sites, jsites


@pytest.fixture(scope="module")
def synthetic_reports():
    """The port's and the JAX package's reports on the synthetic sites,
    over a grid of two geometries and the three precisions."""
    sites, jsites = _synthetic_sites()
    kw = dict(geometries=((16, 16), (8, 32)))
    return (SW.build_sweep_report(sites, SW.sweep_grid(**kw)),
            JSW.build_sweep_report(jsites, JSW.sweep_grid(**kw)))


def test_build_sweep_report_on_synthetic_sites_equals_jax(synthetic_reports,
                                                         tmp_path):
    rep, jrep = synthetic_reports
    assert len(rep.rows) == 80
    _rows_close(rep.rows, jrep.rows)
    assert rep.front == jrep.front and rep.front
    assert rep.beats_fixed == jrep.beats_fixed
    ref = next(r for r in rep.rows if r["name"] == SW.REFERENCE)
    assert ref["saving_total"] == 0.0 and ref["saving_streaming"] == 0.0
    assert rep.table().splitlines()[0] == jrep.table().splitlines()[0]
    rep.to_json(str(tmp_path / "s.json"))
    rep.to_csv(str(tmp_path / "s.csv"))
    jrep.to_json(str(tmp_path / "j.json"))
    got = json.loads((tmp_path / "s.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert {k: v for k, v in got.items() if k != "rows"} == {
        k: v for k, v in want.items() if k != "rows"}
    assert len((tmp_path / "s.csv").read_text().splitlines()) == 81
    sites, _ = _synthetic_sites()
    with pytest.raises(ValueError, match="must contain"):
        SW.build_sweep_report(sites, SW.sweep_grid()[2:])


def _goldens_cases(rep):
    """The report, and copies that break each golden in turn."""
    import copy
    worse = copy.deepcopy(rep)
    worse.front = worse.front[:1]
    worse.beats_fixed = worse.beats_fixed[:3]
    lossless = copy.deepcopy(rep)
    lossless.front = [i for i in lossless.front
                      if lossless.rows[i]["precision"] == "bf16"]
    return (rep, worse, lossless)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_check_goldens_gives_the_jax_failures(synthetic_reports, case):
    from benchmarks import design_sweep as jbench
    assert bench.GOLDENS == jbench.GOLDENS
    rep, jrep = synthetic_reports
    got = bench.check_goldens(_goldens_cases(rep)[case])
    assert got == jbench.check_goldens(_goldens_cases(jrep)[case])
    assert got          # two geometries cannot reach the full-grid floors


# --------------------------------------------------------------- the sites
@pytest.fixture(scope="module")
def collected():
    """Both packages' ``collect_sites`` over ResNet50 at 32 px and the
    three smoke LMs (the JAX package's weights carried across), and the
    JAX tracer's raw sites, teed off its ``trace_fn``."""
    params, raw = {}, []
    for arch in LMS:
        jp = jlm.init_model(jax.random.key(0), JSMOKES[arch])
        tree = jax.tree.map(lambda p: np.asarray(p.value), jp,
                            is_leaf=is_param)
        params[arch] = convert.params_from_jax(tree, SMOKES[arch])
    traced = JI.trace_fn

    def tee(fn, *args, emit, **kw):
        def both(site):
            raw.append(site)
            emit(site)
        return traced(fn, *args, emit=both, **kw)

    JI.trace_fn = tee
    try:
        jsites = JSW.collect_sites(nets=("resnet50",), archs=LMS, res=32,
                                   sample=SAMPLE)
    finally:
        JI.trace_fn = traced
    sites = SW.collect_sites(nets=("resnet50",), archs=LMS, res=32,
                             sample=SAMPLE, device="cpu", params=params)
    return sites, jsites, raw


def test_collect_sites_names_and_weights_equal_jax(collected):
    sites, jsites, raw = collected
    assert sites.names == jsites.names and len(raw) == len(sites.names)
    assert sum(n.startswith("resnet50:") for n in sites.names) == 54
    assert sites.sample == tuple(jsites.sample) == SAMPLE
    np.testing.assert_array_equal(sites.weights.numpy(),
                                  np.asarray(jsites.weights))
    assert sites.A.shape == (len(raw),) + SAMPLE[:2]
    assert sites.A.dtype == sites.W.dtype == torch.bfloat16


def test_fitting_the_jax_tracer_operands_is_bitwise(collected):
    """The port's fit of every site the JAX tracer emitted (its own
    operands, carried across): the JAX package's samples bit for bit."""
    sites, jsites, raw = collected
    Ms, Ks, Ns = SAMPLE
    for i, s in enumerate(raw):
        lhs = torch.from_numpy(_np(s.lhs[0])).to(
            torch.bfloat16 if s.lhs.dtype == jnp.bfloat16 else
            torch.float32)
        rhs = torch.from_numpy(_np(s.rhs[0])).to(
            torch.bfloat16 if s.rhs.dtype == jnp.bfloat16 else
            torch.float32)
        a = SW._fit_axis(SW._fit_axis(lhs, Ms, 0), Ks, 1).to(torch.bfloat16)
        w = SW._fit_axis(SW._fit_axis(rhs, Ks, 0), Ns, 1).to(torch.bfloat16)
        np.testing.assert_array_equal(a.float().numpy(), _np(jsites.A[i]),
                                      jsites.names[i])
        np.testing.assert_array_equal(w.float().numpy(), _np(jsites.W[i]),
                                      jsites.names[i])


def test_the_port_forward_samples_are_bitwise_where_shared(collected):
    sites, jsites, _ = collected
    A, W = sites.A.float().numpy(), sites.W.float().numpy()
    JA, JW = _np(jsites.A), _np(jsites.W)
    n_lm = 0
    for i, name in enumerate(sites.names):
        np.testing.assert_array_equal(W[i], JW[i], name)
        if not name.startswith("resnet50:") or i == 0:   # the stem: image
            np.testing.assert_array_equal(A[i], JA[i], name)
            n_lm += not name.startswith("resnet50:")
    assert n_lm == 19 + 19 + 25


# -------------------------------------------------------------------- CLIs
def test_sweep_cli_quick_on_the_cpu(tmp_path, capsys):
    SW.main(["--quick", "--device", "cpu", "--res", "32", "--json",
             str(tmp_path / "s.json"), "--csv", str(tmp_path / "s.csv")])
    out = capsys.readouterr().out
    assert out.startswith("grid: 240 design points")
    assert "sites: 54 traced matmuls fitted to 64x64x64" in out
    assert "pareto front" in out
    payload = json.loads((tmp_path / "s.json").read_text())
    assert payload["n_points"] == 240 and payload["n_sites"] == 54
    assert len((tmp_path / "s.csv").read_text().splitlines()) == 241


def test_bench_design_sweep_quick_artifact_passes_the_schema(tmp_path,
                                                             capsys):
    path = tmp_path / "BENCH_sweep.json"
    bench.main(quick=True, emit_json=str(path), device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("design_sweep,") and "GOLDEN FAIL" not in out
    payload = json.loads(path.read_text())
    cell = payload["cells"]["design_sweep"]
    assert cell["golden_failures"] == [] and cell["n_points"] == 240
    assert payload["goldens"] == bench.GOLDENS and payload["quick"]
    rc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_bench_schema.py"),
         "--schema", str(ROOT / "schemas" / "bench_sweep.schema.json"),
         str(path)], capture_output=True, text=True)
    assert rc.returncode == 0, rc.stdout + rc.stderr


def test_trace_full_model_rows_and_the_pending_cell(monkeypatch, capsys):
    from benchmarks import trace_full_model as jtfm
    assert tfm.ARCH_CELLS == jtfm.ARCH_CELLS
    assert tfm.NET_CELLS == jtfm.NET_CELLS
    monkeypatch.setattr(tfm, "ARCH_CELLS", [
        ("phi3.5-moe-42b-a6.6b", "forward"), ("recurrentgemma-9b",
                                               "forward")])
    monkeypatch.setattr(tfm, "NET_CELLS", [])
    tfm.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("trace_phi3.5-moe-42b-a6.6b_forward_sites,")
    assert lines[0].endswith(",25")
    # the recurrentgemma cell traces (5 smoke layers: 42 sites)
    assert lines[2].startswith("trace_recurrentgemma-9b_forward_sites,")
    assert lines[2].endswith(",42")
    assert lines[3].startswith("trace_recurrentgemma-9b_forward_saving,")
    assert not any("pending" in line for line in lines)


def test_trace_full_model_quick_on_the_cpu(capsys):
    tfm.main(quick=True, device="cpu")
    rows = [l.split(",") for l in capsys.readouterr().out.splitlines()
            if not l.startswith("#")]
    assert [r[0] for r in rows] == [
        "trace_qwen1.5-0.5b_forward_sites",
        "trace_qwen1.5-0.5b_forward_saving",
        "trace_resnet50_sites", "trace_resnet50_saving"]
    assert rows[0][2] == "19" and rows[2][2] == "54"


def test_trace_lm_power_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.apps import trace_lm_power
    trace_lm_power.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke",
                         "--device", "cpu", "--seq", "8",
                         "--decode-steps", "2", "--json",
                         str(tmp_path / "p.json")])
    out = capsys.readouterr().out
    assert "phi3.5-moe-42b-a6.6b[forward]" in out
    assert "phi3.5-moe-42b-a6.6b[decode]" in out
    payload = json.loads((tmp_path / "p.json").read_text())
    assert payload["model"] == "phi3.5-moe-42b-a6.6b[decode]"
