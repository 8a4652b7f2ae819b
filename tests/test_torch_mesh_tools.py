"""The port's dry-run tooling (``repro_torch.launch.{graph_analysis,
roofline,dryrun}``), as ``tests/test_launch_tools.py`` holds the JAX
package's:

* ``graph_analysis`` on a synthetic program on a fake 8-rank mesh -- 12
  steps of a contracting-dim-sharded matmul and its all-reduce, then an
  all-gather: per-rank dot FLOPs and collective bytes by kind equal the
  hand count; ``FlopCounterMode`` over the same program counts the
  GLOBAL FLOPs (the per-rank figure comes from the local ops);
* roofline ``terms`` on a hand-made record, against the H100 constants;
* one smoke-size dry-run cell (the smoke Qwen1.5-0.5B, one decode step
  at ``decode_32k`` on the 16x16 mesh of a fake 256-rank group), whose
  MODEL_FLOPS / counted FLOPs ratio lies in [0.5, 2] (1.000 when
  written), and ``bench.run``'s roofline summary read from the cache.
"""
import json

import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.launch import dryrun, graph_analysis as G, roofline
from repro_torch.launch.mesh import fake_world

M, K, N, STEPS = 8, 16, 16, 12


def _program(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.randn(M, K), mesh, [Replicate(), Shard(1)])
    w = distribute_tensor(torch.randn(K, N), mesh, [Replicate(), Shard(0)])

    def prog(x, w):
        for _ in range(STEPS):
            y = x @ w                          # Partial over "model"
            y = y.redistribute(mesh, [Replicate(), Replicate()])
            x = y.redistribute(mesh, [Replicate(), Shard(1)])
        return x.redistribute(mesh, [Replicate(), Replicate()])
    return prog, x, w


@pytest.fixture
def mesh8():
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(8):
        yield init_device_mesh("cpu", (2, 4),
                               mesh_dim_names=("data", "model"))


def test_graph_analysis_counts_per_rank(mesh8):
    prog, x, w = _program(mesh8)
    res = G.analyze(prog, x, w)
    k_local = K // 4                           # K over model = 4
    assert res["dot_flops"] == STEPS * 2 * M * N * k_local
    assert res["per_kind"]["all-reduce"] == STEPS * M * N * 4
    assert res["per_kind"]["all-gather"] == M * N * 4
    assert res["per_kind"]["reduce-scatter"] == 0
    assert res["per_kind"]["all-to-all"] == 0
    assert res["total"] == (STEPS + 1) * M * N * 4
    assert res["ops"] == STEPS + 1
    assert res["arg_bytes"] == (M * k_local + k_local * N) * 4
    assert res["mem_bytes"] > STEPS * M * N * 4
    assert res["peak_bytes"] >= res["arg_bytes"]


def test_graph_analysis_same_under_fake_tensors(mesh8):
    from torch._subclasses.fake_tensor import FakeTensorMode
    prog, x, w = _program(mesh8)
    want = G.analyze(prog, x, w)
    with FakeTensorMode(allow_non_fake_inputs=True):
        prog, x, w = _program(mesh8)
        got = G.analyze(prog, x, w)
    for k in ("dot_flops", "per_kind", "total", "ops", "arg_bytes"):
        assert got[k] == want[k], k


def test_flop_counter_mode_counts_global_flops(mesh8):
    from torch.utils.flop_counter import FlopCounterMode
    prog, x, w = _program(mesh8)
    with FlopCounterMode(display=False) as fc:
        prog(x, w)
    assert fc.get_total_flops() == STEPS * 2 * M * N * K       # global
    assert G.analyze(prog, x, w)["dot_flops"] * 4 == fc.get_total_flops()


def test_roofline_terms_on_a_hand_record():
    rec = {
        "status": "ok", "n_ranks": 256,
        "graph": {"dot_flops_per_rank": roofline.PEAK_FLOPS,
                  "mem_bytes_per_rank": roofline.HBM_BW,
                  "collective_bytes_per_rank": roofline.NVLINK_BW / 2},
        "model_flops": {"total": roofline.PEAK_FLOPS * 256 * 0.5},
        "memory": {"peak_bytes_per_rank": 2 ** 30},
    }
    t = roofline.terms(rec)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["bottleneck"] in ("compute", "memory")
    assert t["mfu_bound"] == pytest.approx(0.5)
    assert t["useful_ratio"] == pytest.approx(0.5)
    assert t["fits"] and t["peak_gib"] == pytest.approx(1.0)
    assert roofline.terms({"status": "error"}) is None
    # the H100 SXM5 80GB datasheet figures, nothing else
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.HBM_BYTES) == (989e12, 3.35e12, 900e9, 80e9)


def test_smoke_dryrun_cell_and_the_roofline_summary(tmp_path, capsys,
                                                    monkeypatch):
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False,
                          str(tmp_path), cfg=SMOKES["qwen1.5-0.5b"])
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_ranks"] == 256 and rec["mesh"] == "16x16"
    assert 0.5 <= rec["model_to_counted_flops"] <= 2.0
    g = rec["graph"]
    assert g["dot_flops_per_rank"] > 0 and g["collective_bytes_per_rank"] > 0
    assert set(g["collectives_per_kind"]) == set(G.COLLECTIVES)
    on_disk = json.loads((tmp_path /
                          "qwen1.5-0.5b__decode_32k__pod1.json").read_text())
    assert on_disk["graph"] == g
    # the cache is read back, not recomputed
    assert dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False,
                           str(tmp_path)) == on_disk
    t = roofline.terms(rec)
    assert "decode_32k" in roofline.cell_report(
        "qwen1.5-0.5b", "decode_32k", results_dir=str(tmp_path))
    from repro_torch.bench import run
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    assert run.run_suites([], device="cpu") == 0
    out = capsys.readouterr().out
    assert "roofline (from dry-run cache)" in out
    assert "H100" in out and "qwen1.5-0.5b" in out
    assert f"{t['compute_s']:9.4f}" in out
