"""The port's MoE FFN (``repro_torch.models.moe``) and the dense and MoE
archs it added to the registry (Granite-3.0-2B, DeepSeek-67B,
Phi-3.5-MoE) against the live JAX package at smoke size, on the same
weights (carried across by ``models.convert``) and numpy-made inputs.

Tolerances:
* routing (dispatch, top-k order, occupancy, dropped tokens): exact;
  combine weights and the load-balancing loss within rtol 1e-6 (two
  frameworks' float32 softmax);
* the MoE layer's output in float32 within 2e-6 of its largest
  magnitude (float32 dots summed apart);
* logits as ``tests/test_torch_models.py`` pins them for Qwen: 2e-6
  (float32) and 2e-2 (bfloat16) of the step's largest |logit|, greedy
  tokens equal;
* the whole model's load-balancing loss within rtol 1e-6 in float32. In
  bfloat16 the second layer's router sees hidden states that part where
  the two frameworks round bf16 products apart, so there it holds within
  rtol 1e-3 (measured 6.8e-5 on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SMOKES as JSMOKES
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.layers import is_param
from repro_torch.configs import ARCHS, SMOKES, get_config
from repro_torch.models import convert, lm
from repro_torch.models import moe as M
from repro_torch.models.config import (ArchConfig, MoEConfig, jax_fields,
                                       jax_form)

MOE = "phi3.5-moe-42b-a6.6b"
NEW_ARCHS = ("granite-3-2b", "deepseek-67b", MOE)
CACHE_LEN = 40
LOGIT_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
RTOL = 1e-6


def jax_tree(params):
    return jax.tree.map(lambda p: np.asarray(p.value), params,
                        is_leaf=is_param)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# ---------------------------------------------------------------- routing
def _tied_logits(g: int, s: int, e: int, seed: int) -> np.ndarray:
    """Small integer logits: many exact ties between experts, in the
    softmax probabilities too."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, (g, s, e)).astype(np.float32)


@pytest.mark.parametrize("g,s,e,k,capacity", [
    (2, 8, 4, 2, 1),      # heavy overflow: most tokens dropped
    (2, 8, 4, 2, 3),
    (1, 16, 4, 1, 2),
    (3, 5, 6, 2, 5),      # no overflow
    (2, 1, 4, 2, 1)])     # a decode step: one token a group
def test_topk_dispatch_equal_on_planted_ties_and_overflow(g, s, e, k,
                                                          capacity):
    """Exact ties pick the lower expert first (``jax.lax.top_k``), the
    occupancy cumsum runs over ``s`` within each group, and overflowing
    tokens get no slot: dispatch equal, combine and aux within rtol
    1e-6."""
    logits = _tied_logits(g, s, e, seed=g * 100 + s + capacity)
    jd, jc, jaux = jmoe._topk_dispatch(jnp.asarray(logits), k, capacity)
    d, c, aux = M._topk_dispatch(torch.from_numpy(logits), k, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    # every (group, expert) holds at most `capacity` tokens, one a slot
    assert d.sum(dim=1).max() <= 1.0
    assert d.sum(dim=(1, 3)).max() <= capacity


def test_top_k_is_stable_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4]])
    vals, idx = M._top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 3]]
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropped_tokens_and_empty_slots_equal_jax(dtype):
    """Every token's first choice is expert 0, whose 6 slots overflow
    (10 of 16 tokens a group dropped there), while the second choices
    leave slots of the other experts empty: the dispatched expert inputs
    hold the same all-zero rows as the JAX package's (the streams
    zero-value gating exploits)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    logits = (rng.standard_normal((2, 16, 4)) * 0.5
              + np.array([4.0, 0.0, 0.0, 0.0])).astype(np.float32)
    jd, _, _ = jmoe._topk_dispatch(jnp.asarray(logits), 2, 6)
    jdt = jnp.dtype(dtype)
    jxin = jnp.einsum("gsec,gsd->gecd", jd.astype(jdt),
                      jnp.asarray(x).astype(jdt))
    tdt = getattr(torch, dtype)
    d, _, _ = M._topk_dispatch(torch.from_numpy(logits), 2, 6)
    xin = torch.einsum("gsec,gsd->gecd", d.to(tdt),
                       torch.from_numpy(x).to(tdt))
    np.testing.assert_array_equal(xin.float().numpy(),
                                  np.asarray(jxin.astype(jnp.float32)))
    assert d[:, :, 0].sum(dim=(1, 2)).tolist() == [6.0, 6.0]
    empty = int((xin.abs().sum(-1) == 0).sum())
    assert empty == int((np.abs(np.asarray(jxin, np.float32)).sum(-1)
                         == 0).sum()) > 0


@pytest.mark.parametrize("num_shared", [0, 1])
def test_apply_moe_matches_jax(num_shared):
    """The whole layer in float32, with and without a shared expert:
    output within 2e-6 of its largest magnitude, aux within rtol 1e-6."""
    cfg = MoEConfig(num_experts=4, top_k=2, expert_ff=16,
                    num_shared=num_shared, capacity_factor=1.0,
                    group_size=8)
    jp = jmoe.make_moe(jax.random.key(1), 12, cfg)
    tree = jax_tree(jp)
    p = convert._tensors(tree, "cpu")
    x = np.random.default_rng(2).standard_normal((3, 16, 12)).astype(
        np.float32)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), cfg)
    y, aux = M.apply_moe(p, torch.from_numpy(x), cfg)
    _close(y.numpy(), jy, 2e-6, "moe output")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    assert ("shared" in p) == bool(num_shared)


def test_make_moe_shapes_match_jax():
    cfg = JSMOKES[MOE].moe
    jp = jax_tree(jmoe.make_moe(jax.random.key(0), 64, cfg))
    p = M.make_moe(64, cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: v.shape for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in p.values())


# ------------------------------------------------------- bf16 arithmetic
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_silu_and_scalar_multiples_round_as_jax(dtype):
    """The MLP's and the experts' SiLU and Granite's residual scale
    (``x + 0.22 * y``, 0.22 a weakly typed scalar in JAX) give the JAX
    package's bits: in bf16 every word (fault 8); in float32 within 4 ulps
    (the two frameworks' float32 exp part by an ulp, and the reciprocal
    and product carry it; measured 2 ulps)."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(50000) * 4).astype(np.float32)
    y = rng.standard_normal(50000).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jy = jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)
    tx, ty = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    got = [L.silu(tx), tx + L.weak(0.22, ty.dtype) * ty]
    want = [jax.nn.silu(jx), jx + 0.22 * jy]
    for g, w in zip(got, want):
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -21, atol=1e-30)


@pytest.mark.parametrize("name", ["gelu", "sigmoid", "silu"])
def test_gelu_and_sigmoid_round_as_jax_on_every_bf16_word(name):
    """bf16 ``gelu``, ``sigmoid`` (and ``silu``) equal ``jax.nn.gelu``,
    ``jax.nn.sigmoid`` and ``jax.nn.silu`` on every one of the 65 536 bf16
    bit patterns, NaNs at the same words (fault 9: ``F.gelu(approximate=
    "tanh")`` parts from XLA's expansion in about 43% of bf16 words,
    ``torch.sigmoid`` in about 34%, and XLA flushes subnormals)."""
    from repro_torch.models import layers as L
    bits = np.arange(65536, dtype=np.uint16)
    t = torch.from_numpy(bits.astype(np.int32)).to(torch.int16).view(
        torch.bfloat16)
    j = jnp.asarray(bits).view(jnp.bfloat16)
    got = getattr(L, name)(t)
    want = jax.jit(getattr(jax.nn, name))(j)
    gnan = torch.isnan(got.float()).numpy()
    wnan = np.isnan(np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(gnan, wnan)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16)[~gnan],
        np.asarray(want).view(np.uint16)[~wnan])


# --------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_equal_the_jax_registry(arch):
    for table, jtable in ((ARCHS, JARCHS), (SMOKES, JSMOKES)):
        assert jax_fields(table[arch]) == dataclasses.asdict(jtable[arch])
        assert table[arch] == jax_form(table[arch])
    assert get_config(arch) is ARCHS[arch]


#: the archs that were pending before the rest of the zoo landed
ONCE_PENDING = ("deepseek-v2-lite-16b", "minicpm3-4b", "musicgen-medium",
                "qwen2-vl-72b", "recurrentgemma-9b", "xlstm-1.3b")


@pytest.mark.parametrize("arch", ONCE_PENDING)
def test_pending_archs_name_the_roadmap(arch):
    """The six archs of ROADMAP queue 1 step 3 resolve now, CONFIG and
    SMOKE equal field for field to the JAX package's (the port's own
    fields aside: the published DeepSeek-V2-Lite's CONFIG scales its RoPE
    by YaRN and routes dropless, which the JAX package does not model)."""
    for smoke, table, jtable in ((False, ARCHS, JARCHS),
                                 (True, SMOKES, JSMOKES)):
        got = get_config(arch, smoke=smoke)
        assert got is table[arch]
        assert jax_fields(got) == dataclasses.asdict(jtable[arch])
        assert (got == jax_form(got)) == (
            smoke or arch != "deepseek-v2-lite-16b")


def test_moe_blocks_need_a_moe_config():
    with pytest.raises(ValueError, match="MoEConfig"):
        ArchConfig(name="x", family="moe", n_layers=1, d_model=8,
                   n_heads=2, n_kv_heads=2, d_ff=16, vocab=32,
                   pattern=("attn+moe",))


def test_converter_carries_experts_and_the_tail():
    """DeepSeek-67B's smoke config has one scanned pattern group of two
    layers and a tail block; Phi's experts carry across per layer."""
    jcfg, cfg = JSMOKES["deepseek-67b"], SMOKES["deepseek-67b"]
    tree = jax_tree(jlm.init_model(jax.random.key(0), jcfg))
    params = convert.params_from_jax(tree, cfg)
    assert len(params["layers"]) == 3 and cfg.block_specs[-1] == "attn+mlp"
    np.testing.assert_array_equal(params["layers"][2]["ffn"]["down"].numpy(),
                                  tree["stack"]["tail"][0]["ffn"]["down"])
    jcfg, cfg = JSMOKES[MOE], SMOKES[MOE]
    tree = jax_tree(jlm.init_model(jax.random.key(0), jcfg))
    params = convert.params_from_jax(tree, cfg)
    for g, layer in enumerate(params["layers"]):
        for k in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                layer["ffn"][k].numpy(),
                tree["stack"]["groups"]["b0"]["ffn"][k][g])
    w = lm.compute_weights(params, cfg)
    assert w["layers"][0]["ffn"]["router"].dtype == torch.float32
    assert w["layers"][0]["ffn"]["w_up"].dtype == torch.bfloat16


# ------------------------------------------------------------------ models
@pytest.fixture(scope="module", params=[
    (MOE, "float32"), (MOE, "bfloat16"), ("granite-3-2b", "bfloat16"),
    ("deepseek-67b", "bfloat16")], ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, dt = request.param
    jcfg = JSMOKES[arch].with_(compute_dtype=dt)
    cfg = SMOKES[arch].with_(compute_dtype=dt)
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    params = convert.params_from_jax(jax_tree(jparams), cfg)
    return arch, dt, jcfg, jparams, cfg, params


def test_forward_logits_and_aux_match_jax(model):
    arch, dt, jcfg, jparams, cfg, params = model
    w = lm.compute_weights(params, cfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 16))
    jh, _, jaux = jlm.apply_model(jparams, jcfg,
                                  {"tokens": jnp.asarray(toks, jnp.int32)})
    h, _, aux = lm.apply_model(w, cfg, torch.from_numpy(toks).long())
    jl = jlm.logits_fn(jparams, jcfg, jh)
    tl = lm.logits_fn(w, cfg, h)
    _close(tl.numpy(), jl, LOGIT_TOL[dt], f"{arch} forward logits")
    # the argmax agrees but at near ties: where the picks part, the two
    # picks' logits lie within the tolerance of each other on both sides
    # (Phi in bf16: one of 32 positions, a one-ulp tie)
    tl, jl = tl.numpy(), np.asarray(jl)
    got, want = tl.argmax(-1), jl.argmax(-1)
    tol = LOGIT_TOL[dt] * np.abs(jl).max()
    for b, s in zip(*np.nonzero(got != want)):
        for lg in (tl, jl):
            assert abs(lg[b, s, got[b, s]] - lg[b, s, want[b, s]]) <= tol
    assert (got != want).mean() <= 1 / 16
    np.testing.assert_allclose(float(aux), float(jaux),
                               rtol=RTOL if dt == "float32" else 1e-3)
    assert (float(aux) > 0) == (arch == MOE)


def test_prefill_decode_logits_and_greedy_tokens_match_jax(model):
    """Slot prefill of a right-padded prompt, then 6 greedy decode steps
    fed each side's own argmax: logits within LOGIT_TOL, tokens equal
    (the MoE's decode steps run one token a group, capacity 1)."""
    arch, dt, jcfg, jparams, cfg, params = model
    weights = lm.compute_weights(params, cfg)
    rng = np.random.default_rng(0)
    length, bucket = 11, 16
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :length] = rng.integers(0, cfg.vocab, length)
    jl, js = jax.jit(jlm.make_slot_prefill_step(jcfg, CACHE_LEN))(
        jparams, {"tokens": jnp.asarray(toks)}, np.int32(length))
    tl, ts = lm.make_slot_prefill_step(cfg, CACHE_LEN)(
        weights, torch.from_numpy(toks).long(), length)
    _close(tl.numpy(), jl, LOGIT_TOL[dt], f"{arch} prefill logits")
    jdecode = jax.jit(jlm.make_decode_step(jcfg))
    tdecode = lm.make_decode_step(cfg, "auto")
    jtok = ttok = int(jnp.argmax(jl))
    assert ttok == int(tl.argmax())
    for i in range(6):
        pos = length + i
        jl, js = jdecode(jparams, js, {
            "tokens": jnp.asarray([[jtok]], jnp.int32),
            "positions": jnp.asarray([[pos]], jnp.int32)})
        tl = tdecode(weights, ts, torch.tensor([[ttok]]),
                     torch.tensor([[pos]]))
        _close(tl.numpy(), jl, LOGIT_TOL[dt], f"{arch} decode step {i}")
        jtok, ttok = int(jnp.argmax(jl)), int(tl.argmax())
        assert ttok == jtok, (arch, i)
