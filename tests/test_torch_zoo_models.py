"""The six smoke models of the rest of the LM zoo -- DeepSeek-V2-Lite and
MiniCPM3-4B (MLA), RecurrentGemma-9B (RG-LRU with local attention),
xLSTM-1.3B, Qwen2-VL-72B (M-RoPE over embeds) and MusicGen-medium (codes)
-- against the live JAX models, on the same weights (carried across by
``models.convert``) and numpy-made inputs.

Tolerances: logits in bf16 as ``tests/test_torch_models.py`` pins Qwen,
2e-2 of the step's largest |logit|, greedy tokens equal (per codebook
for MusicGen); in float32 within 1e-5 where a recurrence sets it
(RecurrentGemma, xLSTM: the decay and forget gates run through
``softplus`` and ``log_sigmoid``, which the two frameworks round an ulp
apart in some 10% of float32 values, so the recurrent states are not
bitwise; measured at most 1.1e-6 of the largest |logit|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.trace import sweep as jsweep
from repro_torch.configs import SMOKES
from repro_torch.models import convert, lm
from repro_torch.trace import sweep as sw

ZOO = ("deepseek-v2-lite-16b", "minicpm3-4b", "recurrentgemma-9b",
       "xlstm-1.3b", "qwen2-vl-72b", "musicgen-medium")
RECURRENT = ("recurrentgemma-9b", "xlstm-1.3b")
STATE_TOL = 1e-5
LOGIT_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
CACHE_LEN = 40
DECODE_STEPS = 3


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# ------------------------------------------------------------------ models
def _model(arch, dt):
    jcfg = JSMOKES[arch].with_(compute_dtype=dt)
    cfg = SMOKES[arch].with_(compute_dtype=dt)
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(
        lambda p: np.asarray(p.value), jparams, is_leaf=is_param), cfg)
    return jcfg, jparams, cfg, params


def _tensors(batch: dict) -> dict:
    return {k: (torch.from_numpy(np.array(v)).long()
                if np.asarray(v).dtype == np.int32
                else torch.from_numpy(np.array(v, np.float32)))
            for k, v in batch.items()}


def _greedy_inputs(cfg, logits, batch: int, pos: int) -> tuple[dict, dict]:
    """The next decode step's inputs fed each side's own argmax (per
    codebook for codes; embeds archs are fed the JAX package's decode
    embeds), as (JAX batch, port batch)."""
    if cfg.inputs == "embeds":
        jb = jsweep.decode_inputs(cfg, batch, pos)
        return jb, sw.decode_inputs(cfg, batch, pos)
    pick = np.asarray(logits).argmax(-1)           # [B] or [B, K]
    key = cfg.inputs
    ids = pick[..., None].astype(np.int32)
    positions = np.full((batch, 1), pos, np.int32)
    return ({key: jnp.asarray(ids), "positions": jnp.asarray(positions)},
            {key: torch.from_numpy(ids).long(),
             "positions": torch.from_numpy(positions).long()})


@pytest.mark.parametrize("arch,dt", [(a, "bfloat16") for a in ZOO]
                         + [(a, "float32") for a in RECURRENT])
def test_prefill_decode_logits_and_greedy_tokens_match_jax(arch, dt):
    """A prefill of batch 2, seq 12 (the synthetic batch of each input
    kind, the JAX prefill jitted), then 3 greedy decode steps fed each
    side's own picks: logits within LOGIT_TOL (float32 recurrences within
    STATE_TOL) and picks equal at every step. The JAX decode step runs
    eagerly, as its tracer runs it and as the port runs each op: jitted,
    XLA's fusions round bf16 apart from its own eager ops, and
    DeepSeek-V2-Lite's jitted step 2 parts from its eager one at an
    expert-routing near tie (0.18 of the largest |logit|; float32 holds
    within 5e-7 either way)."""
    jcfg, jparams, cfg, params = _model(arch, dt)
    weights = lm.compute_weights(params, cfg)
    tol = (STATE_TOL if dt == "float32" and arch in RECURRENT
           else LOGIT_TOL[dt])
    seq, b = 12, 2
    jb = jsweep.model_inputs(jcfg, b, seq, 0)
    jb.pop("labels", None)
    tb = _tensors(jb)
    jl, js = jax.jit(jlm.make_prefill_step(jcfg, CACHE_LEN))(jparams, jb)
    tl, ts = lm.make_prefill_step(cfg, CACHE_LEN)(
        weights, *lm.model_input(cfg, tb))
    _close(tl.numpy(), jl, tol, f"{arch} prefill logits")
    jdecode = jlm.make_decode_step(jcfg)        # eager: see the docstring
    tdecode = lm.make_decode_step(cfg, "auto")
    for i in range(DECODE_STEPS):
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1), str(i))
        jin, tin = _greedy_inputs(cfg, jl, b, seq + i)
        jl, js = jdecode(jparams, js, jin)
        tl = tdecode(weights, ts, *lm.model_input(cfg, tin))
        _close(tl.numpy(), jl, tol, f"{arch} decode step {i}")
    np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                  np.asarray(jl).argmax(-1))


def test_decode_states_have_the_jax_structure():
    """``make_decode_state`` builds, per mixer, the JAX package's leaves
    with their shapes and dtypes (the latent cache, the ring and its -1
    slots, the conv buffers and float32 recurrent states)."""
    for arch in ZOO:
        jcfg, cfg = JSMOKES[arch], SMOKES[arch]
        jst = jlm.make_decode_state(jcfg, 3, 20)
        tst = lm.make_decode_state(cfg, 3, 20, torch.bfloat16, "cpu")
        jlayers = list(jst["head"])
        for g in range(jcfg.n_groups):
            for i in range(len(jcfg.pattern)):
                jlayers.append(jax.tree.map(lambda a: a[g],
                                            jst["groups"][f"b{i}"]))
        jlayers += list(jst["tail"])
        for jl_, tl_ in zip(jlayers, tst, strict=True):
            jleaves = jax.tree.leaves(jl_)
            tleaves = jax.tree.leaves(tl_)
            assert [(tuple(a.shape), str(a.dtype)) for a in jleaves] == [
                (tuple(t.shape), str(t.dtype).split(".")[-1])
                for t in tleaves], arch
            for a, t in zip(jleaves, tleaves):
                np.testing.assert_array_equal(
                    t.float().numpy(), np.asarray(a, np.float32))


@pytest.mark.parametrize("arch", ZOO)
def test_converter_and_monitor_weights_follow_the_jax_rule(arch):
    """Every leaf carries across (the 3-block and 8-block patterns'
    groups, the head and the tail); ``pick_monitor_weights`` takes the
    first of wq, in_x, up, w_dkv of the pattern's first block (3-D
    flattened) and the FFN's up, as the JAX package's does; the compute
    weights keep Lambda, the sLSTM's r, norms and the router float32."""
    jcfg, jparams, cfg, params = _model(arch, "bfloat16")
    assert len(params["layers"]) == cfg.n_layers
    want = jlm.pick_monitor_weights(jparams)
    got = lm.pick_monitor_weights(params, cfg)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    w = lm.compute_weights(params, cfg)
    for layer in w["layers"]:
        for key, leaf in jax.tree_util.tree_leaves_with_path(layer):
            names = [k.key for k in key]
            f32 = (any("norm" in n for n in names)
                   or names[-1] in ("router", "lambda", "r"))
            assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16
                                  ), (arch, names)
    jtree = jax.tree.map(lambda p: np.asarray(p.value), jparams,
                         is_leaf=is_param)
    flat = jax.tree_util.tree_leaves(params)
    assert sum(a.numel() for a in flat) == sum(
        a.size for a in jax.tree_util.tree_leaves(jtree))
