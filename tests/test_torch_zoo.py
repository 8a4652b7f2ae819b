"""The layers and mixers of the rest of the LM zoo in the port -- MLA (DeepSeek-V2-Lite,
MiniCPM3-4B), RG-LRU with local attention (RecurrentGemma-9B), xLSTM
(xLSTM-1.3B), the M-RoPE VLM backbone (Qwen2-VL-72B) and the codes audio
backbone (MusicGen-medium) -- against the live JAX package, on the same
weights (carried across by ``models.convert``) and numpy-made inputs.

Tolerances:
* the units in float32, at ``tests/test_models_units.py``'s sizes: 2e-6
  of the output's largest magnitude where the two frameworks' float32
  dots and transcendental functions round apart in the last bits (LayerNorm,
  M-RoPE, sinusoidal positions, sliding-window and MLA attention, the
  convolution); 1e-5 where a recurrence carries a float32 state: the
  RG-LRU's decay and the mLSTM's forget gates run through ``softplus`` and
  ``log_sigmoid``, which the two frameworks' ``exp`` and ``log1p`` round an
  ulp apart in some 10% of values, and ``exp`` after them (measured at
  most 1.1e-6; the sLSTM's cell 4e-7);
* the RG-LRU's tree of affine-map combines (:func:`repro_torch.models.
  recurrent.associative_scan`) bitwise against ``jax.lax.
  associative_scan``;
* the registry's mixers and FFNs as the JAX package's.

The six smoke models are held in ``tests/test_torch_zoo_models.py``,
their traced sites in ``tests/test_torch_zoo_trace.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.models.layers import is_param
from repro_torch.configs import SMOKES
from repro_torch.models import attention as A
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X

ZOO = ("deepseek-v2-lite-16b", "minicpm3-4b", "recurrentgemma-9b",
       "xlstm-1.3b", "qwen2-vl-72b", "musicgen-medium")
RECURRENT = ("recurrentgemma-9b", "xlstm-1.3b")
RNG = np.random.default_rng(0)
TOL = 2e-6
STATE_TOL = 1e-5


def _np(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _tree(params):
    """A JAX ``Param`` tree as the port's tensors (float32 masters)."""
    return convert._tensors(jax.tree.map(lambda p: np.asarray(p.value),
                                         params, is_leaf=is_param), "cpu")


# ------------------------------------------------------------------ layers
def test_layer_norm_is_the_population_variance():
    x, s, b = _np(2, 24, 16, scale=3.0) + 1.5, _np(16), _np(16)
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = L.layer_norm(_t(x), _t(s), _t(b))
    _close(got, want, TOL, "layer_norm")
    # torch's default variance divides by n - 1: 1/15 off at width 16
    assert not torch.allclose(_t(x).var(-1), _t(x).var(-1, correction=0))
    p = {"scale": _t(s), "bias": _t(b)}
    assert torch.equal(L.apply_norm("ln", p, _t(x)), got)
    assert set(L.make_norm("ln", 16, torch.Generator())) == {"scale",
                                                             "bias"}


def test_mrope_with_distinct_streams_matches_jax():
    """Distinct t/h/w positions (the synthetic VLM batch gives all three
    streams the same positions, with which M-RoPE is plain RoPE and a test
    proves nothing): the port's bands take their own streams as the JAX
    package's do, and differ from RoPE on the temporal stream alone."""
    x = _np(2, 5, 3, 16)
    pos = RNG.integers(0, 50, (3, 2, 5))
    sections = (4, 2, 2)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections)
    got = L.apply_mrope(_t(x), torch.from_numpy(pos), sections)
    _close(got, want, TOL, "apply_mrope")
    rope = L.apply_rope(_t(x), torch.from_numpy(pos[0]), 1e6)
    assert not torch.allclose(got, rope, atol=1e-3)
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(_t(x), torch.from_numpy(pos), (4, 2, 1))


def test_sinusoidal_positions_match_jax():
    pos = RNG.integers(0, 300, (2, 7))
    want = JL.sinusoidal_positions(jnp.asarray(pos), 16)
    got = L.sinusoidal_positions(torch.from_numpy(pos), 16)
    _close(got, want, TOL, "sinusoidal_positions")


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("s,window,block_q", [(32, 8, 8), (29, 8, 8),
                                              (16, 16, 1024)])
def test_sliding_window_attention_matches_jax(s, window, block_q):
    q, k, v = _np(2, s, 4, 8), _np(2, s, 2, 8), _np(2, s, 2, 8)
    want = JA.sliding_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=block_q)
    got = A.sliding_window_attention(_t(q), _t(k), _t(v), window=window,
                                     block_q=block_q)
    _close(got, want, TOL, "sliding_window_attention")


def _local_cfg():
    return dataclasses.replace(JSMOKES["recurrentgemma-9b"],
                               compute_dtype="float32")


def test_ring_decode_past_a_wrap_matches_jax():
    """A ring of 16 slots after 37 positions (two wraps): the slots hold
    positions 21..36, one of them the step's own; ``_ring_decode`` masks
    by the stored positions as the JAX package's does."""
    jcfg = _local_cfg()
    cfg = SMOKES["recurrentgemma-9b"].with_(compute_dtype="float32")
    w, b = jcfg.window, 2
    bpos = np.array([36, 20])
    slots = np.full((b, w), -1, np.int32)
    for row, last in enumerate(bpos):
        for t in range(max(last - w + 1, 0), last + 1):
            slots[row, t % w] = t
    q, kc, vc = _np(b, 1, 4, 16), _np(b, w, 1, 16), _np(b, w, 1, 16)
    want = JT._ring_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                           jnp.asarray(slots), jnp.asarray(bpos), jcfg, None)
    got = T._ring_decode(_t(q), _t(kc), _t(vc), torch.from_numpy(slots),
                         torch.from_numpy(bpos), cfg, None)
    _close(got, want, TOL, "_ring_decode")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b"])
def test_mla_parallel_and_absorbed_decode_match_jax(arch):
    """MLA without and with q-LoRA: the parallel path and its prefill
    state (the latent cache padded to the cache length), then two absorbed
    decode steps over that cache, in float32."""
    jcfg = JSMOKES[arch].with_(compute_dtype="float32")
    cfg = SMOKES[arch].with_(compute_dtype="float32")
    jp = JT.make_mla(jax.random.key(3), jcfg)
    p = _tree(jp)
    x = _np(2, 11, jcfg.d_model)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    want, jst = JT.apply_mla(jp, jnp.asarray(x), jcfg,
                             positions=jnp.asarray(pos), prefill=True,
                             cache_len=16)
    got, st = T.apply_mla(p, _t(x), cfg, positions=torch.from_numpy(pos),
                          prefill=True, cache_len=16)
    _close(got, want, TOL, "mla parallel")
    for g, w in zip(st, jst):
        _close(g, w, TOL, "mla prefill state")
    for step in range(2):
        xt = _np(2, 1, jcfg.d_model)
        pt = np.array([[11 + step], [11 + step]])
        want, jst = JT.apply_mla(jp, jnp.asarray(xt), jcfg,
                                 positions=jnp.asarray(pt), state=jst)
        got, st = T.apply_mla(p, _t(xt), cfg, positions=torch.from_numpy(pt),
                              state=st)
        _close(got, want, TOL, f"mla absorbed decode {step}")
    for g, w in zip(st, jst):
        _close(g, w, TOL, "mla latent cache")
    # the same step through page tables that lay each row's cache out in
    # order (row r's position t at page 1 + 4 r + t // 4): bitwise the
    # dense absorbed decode, and the pools hold the dense caches
    ps, mp = 4, 4
    pools = tuple(torch.zeros((1 + 2 * mp, ps) + c.shape[2:]) for c in st)
    for pool, c in zip(pools, st):
        pool[1:] = c.reshape((2 * mp, ps) + c.shape[2:])
    pages = torch.arange(1, 1 + 2 * mp).reshape(2, mp)
    xt = _np(2, 1, jcfg.d_model)
    pt = np.array([[13], [13]])
    dense, st = T.apply_mla(p, _t(xt), cfg, positions=torch.from_numpy(pt),
                            state=st)
    paged, pools = T.apply_mla(p, _t(xt), cfg,
                               positions=torch.from_numpy(pt), state=pools,
                               pages=pages)
    np.testing.assert_array_equal(paged.numpy(), dense.numpy())
    for pool, c in zip(pools, st):
        np.testing.assert_array_equal(
            pool[1:].reshape(c.shape).numpy(), c.numpy())


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b"])
@pytest.mark.parametrize("s", [1, 5])
def test_paged_mla_matches_jax(arch, s):
    """The paged MLA branch against the JAX function on the same latent
    page pools: a decode step (S = 1) with a dead row (all-trash table)
    and two rows sharing a page, and a right-padded prefill chunk (S = 5,
    positions -1 past the prompt) of one row; the outputs and the pools
    after the in-place scatter (the pads' writes land in the trash page
    0, which is not compared), float32."""
    jcfg = JSMOKES[arch].with_(compute_dtype="float32")
    cfg = SMOKES[arch].with_(compute_dtype="float32")
    jp = JT.make_mla(jax.random.key(5), jcfg)
    p = _tree(jp)
    ps, npages = 4, 9
    r, dr = jcfg.mla.kv_lora_rank, jcfg.mla.qk_rope_head_dim
    pools = (_np(npages, ps, r), _np(npages, ps, dr))
    if s == 1:
        pages = np.array([[1, 2, 3, 0], [1, 2, 4, 0], [0, 0, 0, 0]],
                         np.int32)
        pos = np.array([[10], [9], [0]])
    else:
        pages = np.array([[5, 6, 7, 0]], np.int32)
        pos = np.array([[6, 7, 8, 9, -1]])
    x = _np(pages.shape[0], s, jcfg.d_model)
    want, (jckv, jkr) = JT.apply_mla(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos, jnp.int32),
        state=tuple(jnp.asarray(a) for a in pools),
        pages=jnp.asarray(pages))
    got, (ckv, kr) = T.apply_mla(
        p, _t(x), cfg, positions=torch.from_numpy(pos),
        state=tuple(_t(a.copy()) for a in pools),
        pages=torch.from_numpy(pages))
    _close(got, want, TOL, f"paged mla S={s}")
    _close(ckv[1:], np.asarray(jckv)[1:], TOL, "paged ckv pool")
    _close(kr[1:], np.asarray(jkr)[1:], TOL, "paged kr pool")


# ------------------------------------------------------------------ rglru
def test_conv1d_parallel_and_decode_match_jax():
    jp = JR.make_conv1d(jax.random.key(0), 6, 4)
    p = _tree(jp)
    x = _np(2, 10, 6)
    _close(R.apply_conv1d(p, _t(x)), JR.apply_conv1d(jp, jnp.asarray(x)),
           TOL, "conv1d")
    buf = jnp.zeros((2, 3, 6))
    tbuf = torch.zeros((2, 3, 6))
    for t in range(10):
        want, buf = JR.conv1d_decode(jp, buf, jnp.asarray(x[:, t]))
        got, tbuf = R.conv1d_decode(p, tbuf, _t(x[:, t]))
        _close(got, want, TOL, f"conv1d decode {t}")
    # the decode buffer is the prefill's tail, left-padded when short
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(buf))
    np.testing.assert_array_equal(R.conv_tail(_t(x[:, :2]), 4).numpy(),
                                  np.asarray(JT._conv_tail(
                                      jnp.asarray(x[:, :2]), 4)))


@pytest.mark.parametrize("n", [1, 2, 7, 16, 17, 33])
def test_associative_scan_combines_in_the_jax_tree(n):
    a = RNG.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    b = _np(2, n, 5)

    def compose(left, right):
        return right[0] * left[0], right[0] * left[1] + right[1]

    ja, jb = jax.lax.associative_scan(compose, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, tb = R.associative_scan(_t(a), _t(b), dim=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_rglru_parallel_and_decode_match_jax():
    """The parallel RG-LRU (with and without a carried state) and its
    decode steps, float32, within STATE_TOL (softplus in float32)."""
    jp = JR.make_rglru(jax.random.key(0), 12)
    p = _tree(jp)
    assert p["lambda"].dtype == torch.float32
    x = _np(2, 17, 12)
    jy, jh = JR.apply_rglru(jp, jnp.asarray(x))
    y, h = R.apply_rglru(p, _t(x))
    _close(y, jy, STATE_TOL, "rglru y")
    _close(h, jh, STATE_TOL, "rglru last state")
    h0 = _np(2, 12)
    jy, jh = JR.apply_rglru(jp, jnp.asarray(x), jnp.asarray(h0))
    y, h = R.apply_rglru(p, _t(x), _t(h0))
    _close(y, jy, STATE_TOL, "rglru y from h0")
    jh, th = jnp.zeros((2, 12)), torch.zeros((2, 12))
    for t in range(17):
        jy, jh = JR.rglru_decode(jp, jh, jnp.asarray(x[:, t]))
        y, th = R.rglru_decode(p, th, _t(x[:, t]))
        _close(y, jy, STATE_TOL, f"rglru decode {t}")
    _close(th, jh, STATE_TOL, "rglru decode state")


# ------------------------------------------------------------------ xlstm
def _mlstm_operands(b=2, s=33, h=2, d=8):
    return ([_np(b, s, h, d) for _ in range(3)]
            + [_np(b, s, h), _np(b, s, h) + 4])


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_mlstm_chunkwise_matches_jax(chunk):
    """The chunkwise form (padded past the last chunk with forget gates
    of 20 and input gates of -1e30) and its final memory."""
    ops = _mlstm_operands()
    want, jst = JX.mlstm_memory_chunkwise(*map(jnp.asarray, ops),
                                          chunk=chunk)
    got, st = X.mlstm_memory_chunkwise(*map(_t, ops), chunk=chunk)
    _close(got, want, STATE_TOL, "mlstm chunkwise")
    for g, w, name in zip(st, jst, "Cnm"):
        _close(g, w, STATE_TOL, f"mlstm chunkwise {name}")


def test_mlstm_recurrent_state_continuation_matches_jax():
    """The recurrent form from ``m = -inf``, then carried across a split
    of the sequence: the same outputs and state as JAX's, and as the
    unsplit run."""
    ops = _mlstm_operands(b=1, s=20, d=4)
    jops, tops = list(map(jnp.asarray, ops)), list(map(_t, ops))
    jfull, _ = JX.mlstm_memory_recurrent(*jops)
    full, _ = X.mlstm_memory_recurrent(*tops)
    _close(full, jfull, STATE_TOL, "mlstm recurrent")
    ja, jst = JX.mlstm_memory_recurrent(*[o[:, :12] for o in jops])
    a, st = X.mlstm_memory_recurrent(*[o[:, :12] for o in tops])
    assert torch.isfinite(st[2]).all()
    jb, _ = JX.mlstm_memory_recurrent(*[o[:, 12:] for o in jops], jst)
    b, _ = X.mlstm_memory_recurrent(*[o[:, 12:] for o in tops], st)
    _close(torch.cat([a, b], 1), jnp.concatenate([ja, jb], 1), STATE_TOL,
           "mlstm continued")
    _close(torch.cat([a, b], 1), full, STATE_TOL, "mlstm continued vs full")


def test_slstm_matches_jax():
    """The sLSTM block (its recurrent matrix read as float32) and one
    decode step from its final cell, in float32."""
    cfg = JSMOKES["xlstm-1.3b"].xlstm
    jp = JX.make_slstm(jax.random.key(2), 32, cfg)
    p = _tree(jp)
    x = _np(2, 9, 32)
    jy, jcell = JX.apply_slstm(jp, jnp.asarray(x), cfg)
    y, cell = X.apply_slstm(p, _t(x), cfg)
    _close(y, jy, STATE_TOL, "slstm")
    for g, w, name in zip(cell, jcell, "cnhm"):
        _close(g, w, STATE_TOL, f"slstm {name}")
    jcfg = JSMOKES["xlstm-1.3b"].with_(compute_dtype="float32")
    buf = jnp.asarray(x[:, -3:])
    xt = _np(2, 1, 32)
    want, jcell2, _ = JT._slstm_decode(jp, jnp.asarray(xt), jcfg, buf, jcell)
    got, cell2, _ = X.slstm_decode(p, _t(xt), cfg, _t(x[:, -3:]), cell)
    _close(got, want, STATE_TOL, "slstm decode")


# ---------------------------------------------------------------- registry
def test_every_mixer_and_ffn_of_the_zoo_is_accepted():
    specs = {s for a in ZOO for s in SMOKES[a].block_specs}
    assert {s.partition("+")[0] for s in specs} == {
        "mla", "rglru", "local", "mlstm", "slstm", "attn"}
    assert {s.partition("+")[2] or "none" for s in specs} == {
        "mlp", "moe", "none"}
    with pytest.raises(ValueError, match="XLSTMConfig"):
        SMOKES["xlstm-1.3b"].with_(xlstm=None)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium"])
def test_model_and_decode_inputs_of_embeds_and_codes_match_jax(arch):
    """The synthetic batch and the decode-step inputs of the embeds and
    codes archs, drawn as the JAX package draws them (numpy only): the
    same values, the decode embeds rounded to bf16 alike."""
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.trace import sweep as jsweep
    from repro_torch.trace import sweep as sw

    jcfg, cfg = JSMOKES[arch], SMOKES[arch]
    want = SyntheticLM(jcfg, DataConfig(seq_len=9, global_batch=3,
                                        seed=5)).batch(0)
    got = sw.model_inputs(cfg, 3, 9, 5)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    for pos in (9, 12):
        jd = jsweep.decode_inputs(jcfg, 3, pos, 5)
        d = sw.decode_inputs(cfg, 3, pos, 5)
        assert set(d) == set(jd)
        for k, v in jd.items():
            np.testing.assert_array_equal(
                d[k].float().numpy(), np.asarray(v, np.float32))
