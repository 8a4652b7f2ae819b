"""The generators are deterministic per seed, and every seed gets the
same lengths in another order."""
import pytest
import torch

from perfbench.harness import core, inputs
from perfbench.harness.traffic import Traffic, lengths
from perfbench.reference import minicpm3 as REFMOD

BIG = 2 ** 31 + 987654321


@pytest.mark.parametrize("traffic", ["chat_closed128", "longdoc_closed8",
                                     "sysprompt_closed32"])
def test_traffic_is_a_function_of_the_seed(traffic):
    spec = core.load_json(core.BENCH_DIR / "traffic" / f"{traffic}.json")
    a, b, c = (Traffic(spec, s, 73448) for s in (BIG, BIG, BIG + 1))
    ra = [a.next() for _ in range(20)]
    assert ra == [b.next() for _ in range(20)]
    rc = [c.next() for _ in range(20)]
    assert ra != rc
    assert sorted(a.prompts) == sorted(c.prompts)
    assert sorted(a.outputs) == sorted(c.outputs)
    lo, hi = spec["prompt"]["lo"], spec["prompt"]["hi"]
    assert lo <= min(a.prompts) and max(a.prompts) <= hi
    for prompt, out, pre in ra:
        assert all(0 <= t < 73448 for t in prompt)
        assert spec["output"]["lo"] <= out <= spec["output"]["hi"]
        if "prefixes" in spec:
            assert prompt[:spec["prefixes"]["length"]] == a.prefixes[pre]


def test_loguniform_quantiles():
    xs = lengths({"dist": "loguniform", "lo": 32, "hi": 256}, 512)
    assert xs == sorted(xs) and xs[0] == 32 and xs[-1] == 256
    assert 85 <= xs[256] <= 95          # the median of log-uniform 32..256
    assert lengths({"dist": "fixed", "lo": 7}, 3) == [7, 7, 7]


def test_inputs_are_a_function_of_the_seed():
    g = lambda s, k: inputs.generator(s, "cpu", k)
    a = inputs.images(2, 16, g(BIG, 2))
    assert torch.equal(a, inputs.images(2, 16, g(BIG, 2)))
    assert not torch.equal(a, inputs.images(2, 16, g(BIG + 1, 2)))
    assert abs(float(a.mean())) < 1e-5
    assert abs(float(a.std(correction=0)) - 1.0) < 1e-4
    from perfbench.reference import resnet50 as R
    w1, bn1 = inputs.cnn_params(R.specs(), g(BIG, 1))
    w2, bn2 = inputs.cnn_params(R.specs(), g(BIG, 1))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert w1["stem"].shape == (7, 7, 3, 64) and w1["fc"].shape == (2048,
                                                                    1000)
    assert all(torch.equal(bn1[k][1], bn2[k][1]) for k in bn1)


def test_lm_params_layout():
    from perfbench_smoke import LM_SMOKE
    from repro_torch.models import lm
    from perfbench.drivers import serve_lm

    cfg = dict(core.load_json(core.BENCH_DIR / "configs" /
                              "minicpm3-4b.json"), **LM_SMOKE)
    p = REFMOD.init_params(cfg, inputs.generator(BIG, "cpu", 1))
    arch = serve_lm.arch_config(cfg)
    ref = lm.init_model(arch, torch.Generator().manual_seed(0))
    shapes = lambda t: (t.shape if isinstance(t, torch.Tensor) else
                        {k: shapes(v) for k, v in t.items()}
                        if isinstance(t, dict) else [shapes(v) for v in t])
    assert shapes(p) == shapes(ref)
    assert p["layers"][1]["ffn"]["up"].dtype == torch.bfloat16
    q = REFMOD.init_params(cfg, inputs.generator(BIG, "cpu", 1))
    assert torch.equal(p["layers"][1]["mixer"]["w_uq"],
                       q["layers"][1]["mixer"]["w_uq"])


def test_strata_give_every_window_the_same_lengths():
    spec = {"clients": 8, "pool": 64, "strata": 8,
            "prompt": {"dist": "loguniform", "lo": 1024, "hi": 4096},
            "output": {"dist": "loguniform", "lo": 2, "hi": 4}}
    ts = [Traffic(spec, s, 100) for s in (BIG, BIG + 1)]
    assert ts[0].prompts != ts[1].prompts
    qs = sorted(ts[0].prompts)
    for t in ts:
        for j in range(0, 64, 8):
            block = sorted(t.prompts[j:j + 8])
            # one length from each stratum of eight quantiles
            assert all(qs[8 * i] <= x <= qs[8 * i + 7]
                       for i, x in enumerate(block))
    with pytest.raises(ValueError):
        Traffic(dict(spec, pool=60), BIG, 100)
