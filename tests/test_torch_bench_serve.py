"""The port's benchmark registry and serving drivers
(``repro_torch.bench``) on the CPU.

* The registry (``bench/run.py``) names every module on disk and the
  JAX package's suites (``benchmarks/run.py``), in its order.
* ``serve_throughput``'s power cell on the JAX weights carried across
  against the live JAX driver's: greedy tokens equal, the serve-wide
  summary within rtol 1e-6.
* ``serve_throughput``, ``serve_kernels`` and ``serve_paging`` run whole
  with ``--quick --device cpu`` (their token-equality checks included),
  and the artifacts of the last two pass their schemas.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro_torch.bench import run, serve_kernels, serve_paging
from repro_torch.bench import serve_throughput as st
from repro_torch.configs import SMOKES
from repro_torch.models import convert

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_is_complete_and_names_the_jax_suites():
    from benchmarks.run import SUITES as JSUITES
    bdir = ROOT / "src" / "repro_torch" / "bench"
    on_disk = {f[:-3] for f in os.listdir(bdir)
               if f.endswith(".py")} - {"run", "common", "__init__"}
    assert on_disk == set(run.SUITES), (
        f"unregistered: {on_disk - set(run.SUITES)}; "
        f"stale: {set(run.SUITES) - on_disk}")
    assert list(run.SUITES) == list(JSUITES)
    assert {k: q for k, (_, q) in run.SUITES.items()} == {
        k: q for k, (_, q) in JSUITES.items()}


def test_run_lists_and_runs_a_suite(capsys, tmp_path, monkeypatch):
    assert run.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list(run.SUITES)
    # the roofline summary at the end reads the port's dry-run cache (an
    # empty one here: the table's header alone)
    from repro_torch.launch import roofline
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    assert run.main(["--only", "overhead_scaling", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "overhead_share_128x128," in out and "CONFIRMED" in out
    tail = out.splitlines()[-4:]
    assert tail[0] == "# ===== roofline (from dry-run cache) ====="
    assert tail[1].startswith("# roofline against NVIDIA H100")
    assert tail[2].startswith("| arch")


@pytest.fixture(scope="module")
def power_cell():
    """The JAX driver's power cell (4 slots, accounting on, its default
    plain route) and the port's on the same weights."""
    from benchmarks import serve_throughput as jst
    jcfg = JSMOKES[jst.ARCH].with_(compute_dtype="float32")
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    prompts = jst._workload(jcfg)
    jeng, jfin, _ = jst._serve(jparams, jcfg, prompts, 4, power=True)
    cfg = SMOKES[st.ARCH].with_(compute_dtype="float32")
    params = convert.params_from_jax(
        jax.tree.map(lambda p: np.asarray(p.value), jparams,
                     is_leaf=is_param), cfg)
    assert st._workload(cfg) == prompts
    eng, fin, _ = st._serve(params, cfg, prompts, 4, power=True,
                            device="cpu")
    return (jeng, {r.uid: r.generated for r in jfin}), (
        eng, {r.uid: r.generated for r in fin})


def test_power_cell_matches_jax(power_cell):
    (jeng, jtoks), (eng, toks) = power_cell
    assert len(toks) == st.N_REQUESTS
    assert toks == jtoks
    want, got = jeng.trace_report().summary(), eng.trace_report().summary()
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert math.isclose(got[k], v, rel_tol=RTOL), k
        elif isinstance(v, dict):
            for d, x in v.items():
                assert math.isclose(got[k][d], x, rel_tol=RTOL), (k, d)
        else:
            assert got[k] == v, k


def _rows(out: str) -> list[str]:
    return [l.split(",")[0] for l in out.splitlines()
            if l and not l.startswith("#")]


def test_serve_throughput_quick_on_the_cpu(capsys):
    st.main(quick=True, device="cpu")
    out = capsys.readouterr().out
    assert _rows(out) == ["serve_b1_throughput", "serve_b4_throughput",
                          "serve_b4_power", "serve_paged_hbm4",
                          "serve_b4_pallas"]
    assert "WARNING" not in out and "same tokens: True" in out
    assert "kernel_backend=auto on cpu" in out


def test_serve_throughput_refuses_a_mesh(capsys):
    """Not refused any more: ``--mesh 1x1`` adds the sharded cell (a
    one-process gloo group, torn down after it), whose greedy tokens
    equal the single-device cells'."""
    import torch.distributed as dist
    st.main(quick=True, mesh_spec="1x1", device="cpu")
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert _rows(out)[-1] == "serve_b4_mesh1x1"
    mesh_row = [l for l in out.splitlines()
                if l.startswith("serve_b4_mesh1x1")][0]
    assert "same tokens: True" in mesh_row


def _check_schema(path: Path, schema: str) -> None:
    rc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_bench_schema.py"),
         "--schema", str(ROOT / "schemas" / schema), str(path)],
        capture_output=True, text=True)
    assert rc.returncode == 0, rc.stdout + rc.stderr


def test_serve_kernels_quick_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "BENCH_kernels.json"
    serve_kernels.main(quick=True, emit_json=str(path), device="cpu")
    out = capsys.readouterr().out
    assert _rows(out) == ["serve_ref", "serve_ref_power", "serve_pallas",
                          "serve_pallas_power", "gated_matmul_zf00",
                          "gated_matmul_zf90", "fused_counter_pass"]
    assert "integer equality CONFIRMED" in out
    assert "the kernel needs the card" in out
    _check_schema(path, "bench_kernels.schema.json")


def test_serve_paging_quick_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "BENCH_serve.json"
    serve_paging.main(quick=True, emit_json=str(path), device="cpu")
    out = capsys.readouterr().out
    assert _rows(out) == ["serve_paging_slot_hbm2slots",
                          "serve_paging_paged_hbm2slots",
                          "serve_paging_chunked_prefill",
                          "serve_paging_prefix_reuse",
                          "serve_paging_power_overhead"]
    assert "tokens bit-equal: True" in out
    _check_schema(path, "bench_serve.schema.json")
