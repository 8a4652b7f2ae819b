"""The DeepSeek-V2-Lite configuration and its cell, at a size the CPU holds:
the files load and are the port's published config; the reference
module's decode products are the gated row matmul's calls of a decode step
and its active parameters those its weights hold; a sound run is correct
and the control and the planted faults are not; the expert kernel's two
readers read whole steps only."""
import copy

import pytest
import torch

from perfbench.harness import core, inputs
from perfbench.reference import deepseek_v2_lite as REF
from perfbench_smoke import run

CELL = "dsv2lite.serve.decode"
#: SERVED_SMOKE's widths (``repro_torch.configs.deepseek_v2_lite``)
SMOKE = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             num_key_value_heads=4, intermediate_size=192, vocab_size=256,
             kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
             v_head_dim=8, n_routed_experts=8, num_experts_per_tok=3,
             n_shared_experts=2, moe_intermediate_size=32)


def smoke_config() -> dict:
    cfg = copy.deepcopy(core.load_json(core.BENCH_DIR / "configs" /
                                       "deepseek-v2-lite.json"))
    cfg.update(SMOKE)
    cfg["rope_scaling"]["original_max_position_embeddings"] = 64
    cfg["port"] = dict(cfg.get("port", {}), attn_block_k=32)
    return cfg


def smoke_files() -> dict:
    files = copy.deepcopy(core.cell_files(CELL))
    files["config"] = smoke_config()
    t = dict(files["traffic"], clients=4, pool=16, strata=1)
    t["prompt"] = dict(t["prompt"], lo=4, hi=16)
    t["output"] = dict(t["output"], lo=2, hi=8)
    files["traffic"] = t
    files["cell"]["engine"] = dict(files["cell"]["engine"], max_slots=4,
                                   cache_len=128)
    files["cell"]["check"] = {"requests": 4}
    files["cell"]["trace_skip"] = 0
    files["cell"]["trace_units"] = 2
    return files


def test_config_and_cell_load():
    bench = core.benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    files = core.cell_files(CELL)
    assert files["cell"]["why"] == cell["why"]
    assert cell["chips"] == 1 and files["config"]["reduced"] == []
    assert core.reference(files["config"]) is REF
    layer = {m["name"] for m in core.metrics_of(bench, CELL, True)}
    # the two new readers, and the accepted serving metrics whose layers
    # the cell runs (the model step, K2 and K3, the device, the whole step)
    assert layer == {"moe.roofline", "moe.device_share",
                     "serve.decode_step_ms", "gated.roofline",
                     "serve.itl_p95_ms", "idle.serve", "mfu.serve"}
    for name in layer:
        assert core.reader(name).read
    e2e = {m["name"] for m in core.metrics_of(bench, CELL, False)}
    assert e2e == {"tokens_per_s", "setup_s"}


def test_config_is_the_ports_published():
    from repro_torch.configs import deepseek_v2_lite as DS
    from perfbench.drivers import serve_lm

    cfg = core.load_json(core.BENCH_DIR / "configs" / "deepseek-v2-lite.json")
    arch = serve_lm.arch_config(cfg)
    assert arch == DS.CONFIG.with_(name=cfg["name"])
    assert REF.matmul_params(cfg) == pytest.approx(2.45e9, rel=0.005)
    nbytes, _ = REF.expert_step(cfg, 128)
    assert 2 * 3 * 64 * 2048 * 1408 * 26 / 1e9 == pytest.approx(28.8, 0.01)
    assert nbytes > 28.8e9


def test_decode_products_are_the_k2_calls_of_a_decode_step(monkeypatch):
    from repro_torch.models import lm
    from repro_torch.models import matmul as mm
    from perfbench.drivers import serve_lm

    cfg = smoke_config()
    arch = serve_lm.arch_config(cfg)
    params = REF.init_params(cfg, inputs.generator(3, "cpu", 1))
    calls = []
    plain = mm.gated_row_matmul

    def counted(x, w, backend=None):
        calls.append(tuple(w.shape))
        return plain(x, w, backend)
    monkeypatch.setattr(mm, "gated_row_matmul", counted)
    weights = lm.compute_weights(params, arch)
    states = lm.make_decode_state(arch, 2, 16, torch.bfloat16, "cpu")
    step = lm.make_decode_step(arch, "auto")
    step(weights, states, torch.tensor([[5], [9]]),
         torch.tensor([[3], [0]]))
    assert calls == REF.decode_products(cfg)


def test_matmul_params_are_the_active_weights():
    cfg = smoke_config()
    params = REF.init_params(cfg, inputs.generator(4, "cpu", 1))
    share = cfg["num_experts_per_tok"] / cfg["n_routed_experts"]
    active = 0.0
    for lp in params["layers"]:
        for k, w in lp["mixer"].items():
            if k != "kv_norm":
                active += w.numel()
        for k, w in lp["ffn"].items():
            if k == "shared":
                active += sum(v.numel() for v in w.values())
            else:
                active += w.numel() * (share if k.startswith("w_") else 1)
    active += params["unembed"].numel()
    assert REF.matmul_params(cfg) == pytest.approx(active, rel=1e-12)


@pytest.fixture(scope="module")
def sound():
    return run(CELL, smoke_files(), control=True)


def test_sound_run_is_correct_and_the_control_is_not(sound):
    assert sound["correct"] is True, sound["checks"]
    assert sound["checks"]["energy_gap"]["value"] == 0.0
    assert sound["attempted"] > 0 and sound["failed"] == 0
    # the control is not correct: at this size by its energies (its
    # logit gap against the full-width limit depends on the seed here)
    assert any(c["value"] > c["limit"] for c in sound["control"].values())
    assert set(sound["metrics"]) == {"tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["token", "half", "answer"])
def test_planted_faults_are_not_correct(fault):
    # every finished request judged, over a window that finishes requests
    # in every row even on a loaded CPU: the half fault leaves half the
    # rows whole
    files = smoke_files()
    files["cell"]["check"] = {"requests": "all"}
    res = run(CELL, files, seconds=1.5, fault=fault)
    assert res["correct"] is False


def _run_with(kernels, units, admitted):
    from perfbench.harness.profile import Summary

    files = core.cell_files(CELL)
    r = core.Run(name=CELL, files=files, seed=1, seconds=1, trace=True,
                 device="cpu")
    r.profiled = Summary(window_s=1.0, units=units, busy_s=0.5,
                         kernels=kernels, gaps=[])
    r.notes = {"admitted_rows": admitted} if admitted else {}
    return r


@pytest.mark.parametrize("metric", ["moe.roofline", "moe.device_share"])
def test_expert_readers_read_whole_steps_only(metric):
    read = core.reader(metric).read
    per = REF.expert_launches(core.cell_files(CELL)["config"])
    assert per == 52
    # 6 steps and 2 admissions: 8 forwards of 52 launches
    whole = {"expert_kernel": [52 * 8, 0.2]}
    got = read(_run_with(whole, 6, [100, 33]))
    assert got is not None and 0 < got < 100
    for kernels, units, admitted in (
            ({"expert_kernel": [52 * 8 - 1, 0.2]}, 6, [100, 33]),
            ({"expert_kernel": [52 * 6, 0.2]}, 6, [100, 33]),
            ({}, 6, []),
            ({"expert_kernel": [52 * 6, 0.0]}, 6, [])):
        assert read(_run_with(kernels, units, admitted)) is None
    r = _run_with(whole, 6, [100, 33])
    r.profiled = None
    assert read(r) is None
    if metric == "moe.device_share":
        assert got == pytest.approx(100 * 0.2 / 0.5)
    else:
        cfg = core.cell_files(CELL)["config"]
        least = sum(max(b / 3.35e12, f / 989e12) for b, f in (
            [REF.expert_step(cfg, 128)] * 6
            + [REF.expert_step(cfg, 128), REF.expert_step(cfg, 64)]))
        assert got == pytest.approx(100 * least / 0.2)


def test_traced_run_at_cpu_size_leaves_the_device_readers_out():
    res = run(CELL, smoke_files(), seconds=1.0, trace=True)
    assert res["device"]["window_s"] > 0
    # the CPU profile holds no expert_kernel: nothing to read, no key
    assert "moe.roofline" not in res["metrics"]
    assert "moe.device_share" not in res["metrics"]
    # the whole step's share reads the host clock and the counts
    assert res["metrics"]["mfu.serve"]["value"] > 0
