"""The plain references against the port at smoke sizes on the CPU: the
counter pass bit for bit, the pricing to the same floats, the ResNet50
capture word for word but for rounding, MiniCPM3's logits within the
bfloat16 program's rounding."""
import pytest
import torch

from perfbench.reference import counters as C
from perfbench.reference import minicpm3 as REF
from perfbench.reference import resnet50 as R
from perfbench.reference import sa

SPECS = [((), False), ((sa.MANT,), True), ((sa.MANT, sa.MANT_EXP, sa.FULL),
                                           False)]


@pytest.mark.parametrize("variants,zvg", SPECS)
def test_counters_bitwise_the_ports(variants, zvg):
    from repro_torch.kernels.power_counters import CounterSpec
    from repro_torch.kernels.power_counters.ref import fused_counters_ref

    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 1 << 16, (3, 37, 50), generator=g)
    x[torch.rand(x.shape, generator=g) < 0.3] = 0
    spec = CounterSpec(bic_variants=variants, zvg=zvg)
    want, wz = fused_counters_ref(x, spec)
    got, gz = C.counters(x, variants, zvg, block_words=37 * 7)
    assert C.rows(variants, zvg) == spec.rows
    assert torch.equal(got, want) and torch.equal(gz, wz)


def test_pricing_the_ports_floats():
    from repro_torch import design as D

    g = torch.Generator().manual_seed(4)
    A = torch.relu(torch.randn(40, 72, generator=g)).to(torch.bfloat16)
    W = torch.randn(72, 24, generator=g).to(torch.bfloat16)
    designs = tuple(D.named_designs().values())
    want = D.evaluate_operands(A, W, designs, backend="ref")
    a, b = sa.edge_streams(A, W)
    rep, low = sa.report(a, b, 40, 72, 24, sa.menu(sa.NAMED),
                         (torch.float32, torch.bfloat16))
    got = sa.evaluate(rep, sa.NAMED)
    for name, r in want.items():
        for comp, v in r["energy"].items():
            assert float(got[name]["energy"][comp]) == float(v), (name, comp)
        assert float(got[name]["h"]) == float(r["h"])
        assert float(got[name]["v"]) == float(r["v"])
    cheap = sa.evaluate(low, sa.NAMED)
    assert float(cheap["proposed"]["energy"]["total"]) != float(
        got["proposed"]["energy"]["total"])


def test_resnet50_capture_the_ports():
    from repro_torch.apps.cnn import nets
    from perfbench.harness import inputs

    g = lambda k: inputs.generator(5, "cpu", k)
    weights, bn = inputs.cnn_params(R.specs(), g(1))
    images = inputs.images(2, 32, g(2))
    traces = nets.forward_with_traces("resnet50", images,
                                      params=nets.Params(weights, bn))
    diff = total = 0
    for (name, A, W), t in zip(R.sites(weights, bn, images), traces):
        assert name == t.name and A.shape == t.A.shape
        assert torch.equal(W.view(torch.int16), t.W.view(torch.int16))
        diff += int((A.view(torch.int16) != t.A.view(torch.int16)).sum())
        total += A.numel()
    # rounding apart grows with depth where BN normalizes few values
    assert diff / total < 0.02
    assert [(n, M, K, N) for n, M, K, N in R.site_shapes(2, 32)] == [
        (t.name, *t.A.shape, t.W.shape[1]) for t in traces]


def test_minicpm3_logits_the_ports():
    from perfbench_smoke import LM_SMOKE
    from repro_torch.models import lm
    from perfbench.drivers import serve_lm
    from perfbench.harness import core, inputs

    cfg = dict(core.load_json(core.BENCH_DIR / "configs" /
                              "minicpm3-4b.json"), **LM_SMOKE)
    params = REF.init_params(cfg, inputs.generator(6, "cpu", 1))
    arch = serve_lm.arch_config(cfg)
    toks = torch.randint(0, 256, (1, 19), generator=torch.Generator()
                         .manual_seed(6))
    weights = lm.compute_weights(params, arch)
    h, _, _ = lm.apply_model(weights, arch, toks)
    port = lm.logits_fn(weights, arch, h[0])
    ref = REF.logits(params, cfg, toks[0].tolist(), list(range(19)))
    scale = float(ref.abs().max())
    assert float((port - ref).abs().max()) < 0.05 * scale
    low = REF.logits(params, cfg, toks[0].tolist(), list(range(19)),
                     lowp="fp8")
    assert float((low - ref).abs().max()) > float((port - ref).abs().max())
