"""DeepSeek-V2-Lite as it is served, on the CPU at smoke widths in float32
(``configs/deepseek_v2_lite.py::SERVED_SMOKE``: the dense first layer,
shared experts, 8 routed experts top-3, YaRN over 64 original positions):

* the slot engine and the paged engine with ample pages (whole prompts
  and chunked), prefill then decode through the cache, against the
  benchmark's plain reference (``perfbench/reference/deepseek_v2_lite.py``)
  on its seeded weights, by logits;
* dropless routing against a per-token loop over each token's own top-k,
  bit for bit, whatever batch mates or padding share the call; and the
  capacity route where no expert overflows, to rounding;
* YaRN's frequencies and softmax scale against the published formula,
  and every other registered config's RoPE, MLA scale and MoE route as
  they were (plain RoPE, capacity routing), which the JAX-parity tests of
  the zoo then hold bit for bit;
* the MoE's spans under the recorder, and the dropless layer's gradients
  under autograd (the plain route; K8 refuses to record).

No JAX here: the reference is the benchmark's plain PyTorch one.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, SMOKES
from repro_torch.configs import deepseek_v2_lite as DS
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.config import jax_form
from repro_torch.runtime import spans
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.paging import PagingConfig
from repro_torch.serve.request import Request

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from perfbench.reference import deepseek_v2_lite as REF  # noqa: E402

#: the benchmark's configuration file at SERVED_SMOKE's widths
SMOKE_KEYS = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                  num_key_value_heads=4, intermediate_size=192,
                  vocab_size=256, kv_lora_rank=16, qk_nope_head_dim=8,
                  qk_rope_head_dim=8, v_head_dim=8, n_routed_experts=8,
                  num_experts_per_tok=3, n_shared_experts=2,
                  moe_intermediate_size=32, init={"embed_std": 1.0})


def smoke_file() -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs" /
                      "deepseek-v2-lite.json").read_text())
    cfg.update(SMOKE_KEYS)
    cfg["rope_scaling"] = dict(cfg["rope_scaling"],
                               original_max_position_embeddings=64)
    return cfg


def served_arch(cfg: dict):
    """The port's config of a benchmark configuration file, as the
    serving harness builds it (the file's ``port`` knobs on top)."""
    from perfbench.drivers import serve_lm
    return serve_lm.arch_config(cfg)


def test_served_smoke_is_the_reference_files_arch():
    arch = served_arch(smoke_file())
    assert arch == DS.SERVED_SMOKE.with_(name=arch.name, attn_block_k=1024)
    assert served_arch(json.loads((ROOT / "perfbench" / "configs" /
                                   "deepseek-v2-lite.json").read_text())
                       ) == DS.CONFIG.with_(name="deepseek-v2-lite")


# ------------------------------------------------------------------ YaRN
def _published_inv_freq(dim, base, factor, orig, beta_fast, beta_slow):
    """DeepseekV2YarnRotaryEmbedding's inverse frequencies, in float64."""
    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    out = []
    for i in range(dim // 2):
        extra = 1.0 / base ** (2 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        mask = 1.0 - ramp
        out.append(extra / factor * (1 - mask) + extra * mask)
    return torch.tensor(out, dtype=torch.float64)


@pytest.mark.parametrize("cfg,dims", [(DS.CONFIG, (10, 23)),
                                      (DS.SERVED_SMOKE, (0, 2))])
def test_yarn_frequencies_and_scale_are_the_published(cfg, dims):
    rs = cfg.rope_scaling
    d = cfg.mla.qk_rope_head_dim
    assert L.yarn_correction_range(rs.beta_fast, rs.beta_slow, d,
                                   cfg.rope_theta,
                                   rs.original_max_position_embeddings
                                   ) == dims
    got = L.yarn_inv_freq(d, cfg.rope_theta, rs)
    want = _published_inv_freq(d, cfg.rope_theta, rs.factor,
                               rs.original_max_position_embeddings,
                               rs.beta_fast, rs.beta_slow)
    assert torch.allclose(got.double(), want, rtol=1e-6, atol=0)
    # the ramp moves frequencies on both sides of the correction dims
    plain = L.rope_freqs(d, cfg.rope_theta)
    assert torch.equal(got[:dims[0]], plain[:dims[0]])
    assert torch.allclose(got[dims[1]:], plain[dims[1]:] / rs.factor)
    assert not torch.equal(got, plain)
    # the benchmark's reference computes the same float32 frequencies
    assert torch.equal(got, REF.yarn_inv_freq(d, cfg.rope_theta,
                                              dataclasses.asdict(rs)))
    m = 0.1 * 0.707 * math.log(40) + 1
    assert T.mla_scale(cfg) == pytest.approx(
        (cfg.mla.qk_nope_head_dim + d) ** -0.5 * m * m, rel=1e-12)
    assert m * m == pytest.approx(1.5896, abs=1e-4)


def _plain_rope(x, positions, theta):
    """The port's RoPE before YaRN, verbatim."""
    freqs = 1.0 / (theta ** (torch.arange(0, x.shape[-1], 2,
                                          dtype=torch.float32) / x.shape[-1]))
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


REGISTERED = ([(n, c) for n, c in SMOKES.items()]
              + [(n, c) for n, c in ARCHS.items()
                 if c is not DS.CONFIG])


@pytest.mark.parametrize("name,cfg", REGISTERED,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(REGISTERED)])
def test_other_configs_keep_plain_rope_and_capacity_routing(name, cfg):
    assert cfg == jax_form(cfg) and cfg.rope_scaling is None
    g = torch.Generator().manual_seed(5)
    hd = cfg.mla.qk_rope_head_dim if cfg.mla else cfg.hd
    x = torch.randn(2, 9, 3, hd, generator=g).to(torch.bfloat16)
    pos = torch.randint(0, 5000, (2, 9), generator=g)
    got = L.apply_rope(x, pos, cfg.rope_theta, cfg.rope_scaling)
    assert torch.equal(got, _plain_rope(x, pos, cfg.rope_theta))
    if cfg.mla:
        mla = cfg.mla
        assert T.mla_scale(cfg) == (mla.qk_nope_head_dim
                                    + mla.qk_rope_head_dim) ** -0.5
    if cfg.moe:
        assert not cfg.moe.dropless


# ------------------------------------------------------------- dropless
@pytest.fixture(scope="module")
def moe_params():
    cfg = DS.SERVED_SMOKE
    p = M.make_moe(cfg.d_model, cfg.moe, torch.Generator().manual_seed(3))
    return cfg, p


def _routed_alone(p, x_tok, cfg):
    """One token's routed output from its own top-k, expert by expert."""
    mc = cfg.moe
    logits = M._row_product(x_tok[None].float(), p["router"])[0]
    gates, experts = M._top_k(torch.softmax(logits, -1), mc.top_k)
    out = None
    for j in range(mc.top_k):
        e = int(experts[j])
        one = torch.zeros(mc.num_experts + 1, dtype=torch.int32)
        one[e + 1:] = 1
        h = M.expert_matmul(x_tok[None], p["w_gate"], one, 1,
                            w_up=p["w_up"], act=L.silu, backend="ref")
        y = M.expert_matmul(h, p["w_down"], one, 1, backend="ref")[0]
        if out is None:
            out = y.float() * gates[j]
        else:
            out.addcmul_(y.float(), gates[j])
    return out.to(x_tok.dtype)


def test_dropless_is_each_tokens_own_top_k_bit_for_bit(moe_params):
    cfg, p = moe_params
    routed = {k: v for k, v in p.items() if k != "shared"}
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 7, cfg.d_model, generator=g)
    y, _ = M.apply_moe_dropless(routed, x, cfg.moe)
    for b in range(3):
        for s in range(7):
            assert torch.equal(y[b, s], _routed_alone(routed, x[b, s], cfg))
    # batch mates and padding: a row alone, and among zero rows
    y1, _ = M.apply_moe_dropless(routed, x[1:2, 2:5], cfg.moe)
    assert torch.equal(y1, y[1:2, 2:5])
    padded = torch.cat([x[:1], torch.zeros(1, 7, cfg.d_model)], 1)
    y2, _ = M.apply_moe_dropless(routed, padded, cfg.moe)
    assert torch.equal(y2[:, :7], y[:1])
    assert torch.equal(y2[:, 7:], torch.zeros_like(y2[:, 7:]))


def test_dropless_is_the_capacity_route_where_nothing_drops(moe_params):
    cfg, p = moe_params
    x = torch.randn(2, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    y, _ = M.apply_moe(p, x, cfg.moe)
    ample = dataclasses.replace(cfg.moe, dropless=False, group_size=8,
                                capacity_factor=float(cfg.moe.num_experts))
    want, _ = M.apply_moe(p, x, ample)
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-6)
    # capacity 1 a group drops tokens; the dropless route drops none
    tight = dataclasses.replace(ample, capacity_factor=0.3)
    dropped, _ = M.apply_moe(p, x, tight)
    assert not torch.allclose(dropped, want, rtol=1e-3, atol=1e-4)


def test_moe_spans_and_notes(moe_params):
    """The MoE's three spans nest in ``model.moe`` under the recorder (it
    keeps spans and nothing else), and with the recorder off nothing is
    kept."""
    cfg, p = moe_params
    x = torch.randn(1, 5, cfg.d_model)
    spans.enable()
    try:
        with spans.span("model.moe"):
            M.apply_moe(p, x, cfg.moe)
        recs = spans.take()
    finally:
        spans.disable()
    names = [r.name for r in recs]
    assert names[:4] == ["model.moe", "moe.route", "moe.experts",
                         "moe.combine"]
    assert all(recs[i].parent == 0 for i in (1, 2, 3))
    M.apply_moe(p, x, cfg.moe)          # off: nothing kept
    spans.enable()
    try:
        assert spans.take() == []
    finally:
        spans.disable()


def test_dropless_experts_learn_under_autograd(moe_params):
    """With no backend (training's), the routed products take the plain
    route, which autograd differentiates: every routed expert that a token
    picked, the shared experts and the router receive gradients, and the
    gradient reaches the layer's input through the experts too."""
    cfg, p0 = moe_params
    p = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_())
         for k, v in p0.items()}
    x = torch.randn(2, 6, cfg.d_model,
                    generator=torch.Generator().manual_seed(7),
                    requires_grad=True)
    y, aux = M.apply_moe(p, x, cfg.moe)
    (y.square().sum() + aux).backward()
    _, experts = M._top_k(torch.softmax(
        M._row_product(x.detach().reshape(-1, cfg.d_model).float(),
                       p0["router"]), -1), cfg.moe.top_k)
    picked = sorted(set(experts.reshape(-1).tolist()))
    assert len(picked) > 1
    for name in ("w_gate", "w_up", "w_down"):
        g = p[name].grad
        assert g is not None, name
        norms = g.flatten(1).norm(dim=1)
        assert (norms[picked] > 0).all(), name
        unpicked = [e for e in range(cfg.moe.num_experts) if e not in picked]
        assert (norms[unpicked] == 0).all(), name
    assert p["router"].grad.abs().sum() > 0
    assert all(v.grad.abs().sum() > 0 for v in p["shared"].values())
    # the input's gradient holds the routed experts' share: without them
    # (shared experts alone) it differs
    shared_only = x.detach().clone().requires_grad_()
    L.apply_mlp({k: v.detach() for k, v in p["shared"].items()},
                 shared_only, cfg.act).square().sum().backward()
    assert not torch.allclose(x.grad, shared_only.grad)


def test_k8_refuses_what_it_cannot_compute():
    """Checked before anything reaches the card: K8 has no backward, so
    its wrapper refuses operands autograd would record; its gate's
    activation is SiLU, so the entry point refuses another on the kernel's
    route and computes it on the plain one."""
    from repro_torch.kernels.expert_matmul import expert_matmul
    from repro_torch.kernels.expert_matmul import kernel as k8
    x = torch.zeros(2, 64, requires_grad=True)
    w = torch.zeros(1, 64, 8)
    offsets = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        k8.expert_matmul_cuda(x, w, offsets, 2)
    with pytest.raises(ValueError, match="SiLU only"):
        expert_matmul(x, w, offsets, 2, w_up=w, act=L.gelu, backend="cuda")
    y = expert_matmul(x.detach() + 1, w + 1, offsets, 2, w_up=w + 1,
                      act=L.gelu, backend="auto")
    assert torch.equal(y, L.gelu(torch.full((2, 8), 64.0)) * 64)


# ------------------------------------------------- served vs reference
def _capture_logits(eng):
    """Every request's logits as the engine samples them: ``{uid:
    [logits [V], ...]}``, its first token's from its admission, then its
    row of each shared decode it took part in."""
    seen, rows, live_now = {}, {}, []
    first, decode_live, sample = (eng._sample_first, eng._decode_live,
                                  eng._sample)

    def keep_first(req, logits):
        seen[req.uid] = [logits[-1].detach().clone()]
        rows[req.slot] = req.uid
        return first(req, logits)

    def keep_live(live, retired):
        live_now[:] = live
        try:
            return decode_live(live, retired)
        finally:
            live_now.clear()

    def keep_sample(logits, temp, topk):
        for slot in live_now:
            seen[rows[slot]].append(logits[slot].detach().clone())
        return sample(logits, temp, topk)
    eng._sample_first = keep_first
    eng._decode_live = keep_live
    eng._sample = keep_sample
    return seen


@pytest.mark.parametrize("mode", ["slot", "paged", "paged_chunked"])
def test_served_logits_are_the_references(mode):
    cfg = smoke_file()
    params = REF.init_params(cfg, torch.Generator().manual_seed(7))
    arch = served_arch(cfg).with_(compute_dtype="float32", attn_block_k=32)
    paging = None
    if mode != "slot":
        paging = PagingConfig(
            page_size=4, max_rows=2, num_pages=2 * 128 // 4 + 1,
            prefill_chunk=5 if mode == "paged_chunked" else 0)
    eng = ServeEngine(params, arch, ServeConfig(
        max_slots=2, cache_len=128, device="cpu", paging=paging,
        power_monitor=True))
    seen = _capture_logits(eng)
    g = torch.Generator().manual_seed(8)
    # the second prompt runs past the 64 original positions
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist()
               for n in (7, 80)]
    reqs = [eng.submit(Request(prompt=pr, max_new_tokens=6))
            for pr in prompts]
    eng.run()
    worst = 0.0
    for r in reqs:
        assert len(r.generated) == 6 and len(seen[r.uid]) == 6
        got = torch.stack(seen[r.uid])
        assert got.argmax(-1).tolist() == r.generated
        toks = r.prompt + r.generated[:-1]
        ref = REF.logits(params, cfg, toks,
                         list(range(len(r.prompt) - 1, len(toks))))
        worst = max(worst, float((got - ref).abs().max())
                    / float(ref.abs().max()))
    # float32 both: only the order of the sums apart
    assert worst < 2e-5, worst


@pytest.mark.parametrize("kernel_backend", ["auto", "ref"])
@pytest.mark.parametrize("paged", [False, True])
def test_engine_steps_give_the_experts_its_kernel_backend(monkeypatch,
                                                          kernel_backend,
                                                          paged):
    """The engines' prefill (whole or chunked) keeps its matmuls plain but
    hands the routed products the engine's kernel backend, as its decode
    does; a prefill step built without one runs them plain."""
    from repro_torch.models import lm

    seen = []
    real = M.expert_matmul

    def spy(*a, backend=None, **kw):
        seen.append(backend)
        return real(*a, backend=backend, **kw)
    monkeypatch.setattr(M, "expert_matmul", spy)
    cfg = smoke_file()
    params = REF.init_params(cfg, torch.Generator().manual_seed(9))
    arch = served_arch(cfg).with_(compute_dtype="float32", attn_block_k=32)
    paging = (PagingConfig(page_size=4, max_rows=1, num_pages=17,
                           prefill_chunk=4) if paged else None)
    eng = ServeEngine(params, arch, ServeConfig(
        max_slots=1, cache_len=64, device="cpu", paging=paging,
        kernel_backend=kernel_backend))
    eng.submit(Request(prompt=[3, 1, 4, 1, 5, 9], max_new_tokens=3))
    eng.run()
    moe_layers = arch.n_layers - len(arch.head)
    # two products a MoE layer; prefill in 1 (slot) or 2 (paged) calls,
    # then 2 decode steps
    calls = (2 if paged else 1) + 2
    assert seen == [kernel_backend] * (2 * moe_layers * calls)
    seen.clear()
    w = lm.compute_weights(eng.params, arch)
    lm.make_prefill_step(arch, 16)(w, torch.tensor([[1, 2, 3]]))
    assert seen == ["ref"] * (2 * moe_layers)
