"""The serving harness is the same for every language model: a second
architecture (a dense grouped-query decoder) runs through the driver,
the cost functions and the per-layer readers with nothing of its own
but a configuration and the module its ``reference`` key names. Here
that module borrows the port's forward, which a real reference may not:
the test is of the harness's plumbing, not of correctness."""
import copy
import sys
import types

import pytest
import torch

from perfbench.harness import core, costs

NAME = "perfbench.reference.gqa_smoke"
CFG = {"name": "gqa-smoke", "driver": "serve_lm", "reference": "gqa_smoke",
       "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2, "intermediate_size": 128,
       "vocab_size": 256}


def _module():
    from repro_torch.models import lm

    mod = types.ModuleType(NAME)

    def port_arch(cfg):
        return dict(name=cfg["name"], family="dense",
                    n_layers=cfg["num_hidden_layers"],
                    d_model=cfg["hidden_size"],
                    n_heads=cfg["num_attention_heads"],
                    n_kv_heads=cfg["num_key_value_heads"],
                    d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                    pattern=["attn+mlp"], tie_embeddings=True,
                    attn_block_k=32)

    def arch(cfg):
        from perfbench.drivers import serve_lm
        return serve_lm.arch_config(cfg)

    def init_params(cfg, gen):
        p = lm.init_model(arch(cfg), gen)
        p["embed"] = p["embed"].to(torch.bfloat16)
        return p

    def logits(params, cfg, tokens, at, lowp=None):
        a = arch(cfg)
        w = lm.compute_weights(params, a)
        h, _, _ = lm.apply_model(w, a, torch.tensor([tokens]))
        return lm.logits_fn(w, a, h[0, at]).float()

    D, H = CFG["hidden_size"], CFG["num_attention_heads"]
    mod.port_arch = port_arch
    mod.init_params = init_params
    mod.logits = logits
    mod.decode_products = lambda cfg: [(D, D), (D, D // 2), (D, D // 2),
                                       (D, D)] * 2 + [(D, 256)]
    mod.matmul_params = lambda cfg: 2.0 * (3 * D * D + 3 * D * 128) + D * 256
    mod.accountant_sites = lambda cfg: [(D, D), (D, 128)]
    mod.embed_scale = lambda cfg: 1.0
    return mod


@pytest.fixture
def gqa(monkeypatch):
    monkeypatch.setitem(sys.modules, NAME, _module())
    files = copy.deepcopy(core.cell_files("minicpm3.serve.decode"))
    files["config"] = dict(CFG)
    t = dict(files["traffic"], clients=3, pool=16, strata=1)
    t["prompt"] = dict(t["prompt"], lo=4, hi=12)
    t["output"] = dict(t["output"], lo=2, hi=4)
    files["traffic"] = t
    files["cell"]["engine"] = {"max_slots": 3, "cache_len": 64,
                               "kernel_backend": "auto"}
    files["cell"]["check"] = {"requests": "all"}
    files["cell"]["trace_skip"] = 0
    files["cell"]["trace_units"] = 2
    return files


def test_costs_come_from_the_reference_module(gqa):
    cfg = gqa["config"]
    assert costs.k2_launches(cfg) == 9
    assert costs.lm_matmul_params(cfg) == 2.0 * (3 * 64 * 64
                                                 + 3 * 64 * 128) + 64 * 256
    assert len(costs.accountant_sites(cfg)) == 2


@pytest.mark.parametrize("trace", [False, True])
def test_a_second_architecture_runs_through_the_harness(gqa, trace):
    res = core.run_cell(core.benchmark(), "minicpm3.serve.decode",
                        2 ** 31 + 77, 0.5, trace, "cpu", files=gqa)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"logit_gap", "energy_gap",
                                  "report_fields_differ"}
    assert res["checks"]["report_fields_differ"]["value"] == 0
    if trace:
        assert "mfu.serve" in res["metrics"]
    else:
        assert res["metrics"]["tokens_per_s"]["value"] > 0
