"""``correct`` comes out false where it should: the control (the
reference in the next lower precision in the program's place) fails the
cell's comparison, and so does a run whose timed path is broken
underneath -- half of the batch left out, an answer or a token altered
where it is produced. The harness runs whole, but for its look for a
card, at a size the CPU holds."""
import pytest

from perfbench_smoke import run, serve_files

SERVE = ["minicpm3.serve.decode", "minicpm3.serve.prefill",
         "minicpm3.serve.paged_prefix"]


@pytest.mark.parametrize("cell", SERVE)
def test_serve_sound_run_and_control(cell):
    res = run(cell, serve_files(cell), control=True)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["energy_gap"]["value"] == 0.0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert any(c["value"] > c["limit"] for c in res["control"].values())
    assert set(res["metrics"]) >= {"tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["token", "half", "answer"])
def test_serve_faults_are_not_correct(fault):
    cell = "minicpm3.serve.decode"
    res = run(cell, serve_files(cell), fault=fault)
    assert res["correct"] is False


@pytest.mark.parametrize("cell,host_metrics", [
    ("minicpm3.serve.decode", {"serve.decode_step_ms", "serve.itl_p95_ms"}),
    ("minicpm3.serve.prefill", {"serve.admit_ms"}),
    ("minicpm3.serve.paged_prefix", {"serve.ttft_p95_ms"})])
def test_traced_run_reports_per_layer_metrics(cell, host_metrics):
    res = run(cell, serve_files(cell), seconds=2.0, trace=True)
    assert set(res["metrics"]) >= host_metrics | {"mfu.serve"}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
