"""The port's LM (``repro_torch.models``), monitor and report against the
live JAX package at smoke size, on the same weights (carried across by
``models.convert``) and the same numpy-made inputs.

Tolerances, relative to the largest |logit| of the step:
* float32: 2e-6 -- the two frameworks' CPU dots and transcendental
  functions round apart in the last bits;
* bfloat16: 2e-2 -- bf16 rounds at other places in the two frameworks
  (one unit in the last place is 2**-8 relative), through 2 layers.
KV states: float32 2e-6 and bfloat16 2**-7 of the state's largest
magnitude (one bf16 unit at that scale).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.core import monitor as jmonitor
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.trace.capture import TraceCapture as JCapture
from repro.trace.interpret import MatmulSite as JSite
from repro.trace.report import build_report as jbuild_report
from repro_torch.configs import ARCHS, SMOKES, get_config
from repro_torch.core import monitor
from repro_torch.models import convert, lm
from repro_torch.models.config import ArchConfig, jax_fields, jax_form
from repro_torch.trace.capture import MatmulSite, TraceCapture
from repro_torch.trace.report import TraceReport, build_report

ARCH = "qwen1.5-0.5b"
CACHE_LEN = 48
LOGIT_TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def jax_tree(params):
    return jax.tree.map(lambda p: np.asarray(p.value), params,
                        is_leaf=is_param)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dt = request.param
    jcfg = JSMOKES[ARCH].with_(compute_dtype=dt)
    cfg = SMOKES[ARCH].with_(compute_dtype=dt)
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    params = convert.params_from_jax(jax_tree(jparams), cfg)
    return dt, jcfg, jparams, cfg, params


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def test_config_registry_matches_the_jax_package():
    from repro.configs import ARCHS as JARCHS
    assert set(ARCHS) == set(SMOKES) == set(JARCHS) and ARCH in ARCHS
    assert len(ARCHS) == 10
    for table, jtable in ((ARCHS, JARCHS), (SMOKES, JSMOKES)):
        for name in jtable:
            got = jax_fields(table[name])
            want = dataclasses.asdict(jtable[name])
            assert got == want, name
            # the port's own fields at the JAX package's behaviour, but
            # for the published DeepSeek-V2-Lite (YaRN, dropless routing)
            assert (table[name] == jax_form(table[name])) == (
                table[name] is not ARCHS["deepseek-v2-lite-16b"]), name
    assert get_config(ARCH, smoke=True).n_layers == 2
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_blocks_other_than_attn_mlp_name_roadmap_step_8():
    """Every mixer and FFN of the JAX package's zoo is accepted; an
    unknown one raises ValueError naming the spec, as the JAX package's
    ``make_mixer`` does."""
    hybrid = ArchConfig(name="x", family="hybrid", n_layers=3, d_model=8,
                        n_heads=2, n_kv_heads=2, d_ff=16, vocab=32,
                        pattern=("rglru+mlp", "rglru+mlp", "local+mlp"),
                        rglru=SMOKES["recurrentgemma-9b"].rglru)
    assert hybrid.block_specs[-1] == "local+mlp"
    for spec in ("lstm+mlp", "attn+glu"):
        with pytest.raises(ValueError,
                           match=re.escape(f"unknown block {spec!r}")):
            hybrid.with_(pattern=(spec,))
    with pytest.raises(ValueError, match="RGLRUConfig"):
        hybrid.with_(rglru=None)


def test_converter_unstacks_the_scanned_groups(model):
    _, jcfg, jparams, cfg, params = model
    tree = jax_tree(jparams)
    assert len(params["layers"]) == cfg.n_layers
    for g, layer in enumerate(params["layers"]):
        want = tree["stack"]["groups"]["b0"]["mixer"]["wq"][g]
        np.testing.assert_array_equal(layer["mixer"]["wq"].numpy(), want)
        assert layer["mixer"]["wq"].dtype == torch.float32
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])


def test_prefill_decode_logits_and_kv_states_match_jax(model):
    dt, jcfg, jparams, cfg, params = model
    weights = lm.compute_weights(params, cfg)
    rng = np.random.default_rng(0)
    length, bucket = 13, 16
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :length] = rng.integers(0, cfg.vocab, length)
    jl, js = jax.jit(jlm.make_slot_prefill_step(jcfg, CACHE_LEN))(
        jparams, {"tokens": jnp.asarray(toks)}, np.int32(length))
    tl, ts = lm.make_slot_prefill_step(cfg, CACHE_LEN)(
        weights, torch.from_numpy(toks).long(), length)
    _close(tl.numpy(), jl, LOGIT_TOL[dt], "prefill logits")

    def kv(jstates, tstates):
        jk = np.asarray(jstates["groups"]["b0"][0].astype(jnp.float32))
        tk = torch.stack([k for k, _ in tstates]).float().numpy()
        assert tk.shape == jk.shape
        tol = 2e-6 if dt == "float32" else 2.0 ** -7
        _close(tk, jk, tol, "K cache")

    kv(js, ts)
    jdecode = jax.jit(jlm.make_decode_step(jcfg))
    tdecode = lm.make_decode_step(cfg, "auto")
    for i in range(8):                         # teacher-forced steps
        tok, pos = int(rng.integers(0, cfg.vocab)), length + i
        jl, js = jdecode(jparams, js, {
            "tokens": jnp.asarray([[tok]], jnp.int32),
            "positions": jnp.asarray([[pos]], jnp.int32)})
        tl = tdecode(weights, ts, torch.tensor([[tok]]),
                     torch.tensor([[pos]]))
        _close(tl.numpy(), jl, LOGIT_TOL[dt], f"decode step {i}")
        assert int(tl.argmax()) == int(jnp.argmax(jl)), i
    kv(js, ts)


def test_decode_backends_agree_and_none_is_plain_matmul(model):
    dt, _, _, cfg, params = model
    weights = lm.compute_weights(params, cfg)
    states = lm.make_decode_state(cfg, 3, CACHE_LEN, lm.compute_dtype(cfg),
                                  "cpu")
    toks, pos = torch.tensor([[5], [0], [9]]), torch.tensor([[0], [3], [7]])
    outs = [lm.make_decode_step(cfg, b)(weights, [(k.clone(), v.clone())
                                                  for k, v in states],
                                        toks, pos)
            for b in ("auto", "ref", None)]
    assert torch.equal(outs[0], outs[1])
    _close(outs[2].numpy(), outs[0].numpy(), LOGIT_TOL[dt], "plain x @ w")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        lm.make_decode_step(cfg, "pallas")


def test_pick_monitor_weights_matches_jax(model):
    _, _, jparams, cfg, params = model
    want = jlm.pick_monitor_weights(jparams)
    got = lm.pick_monitor_weights(params, cfg)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [n for n, _ in got] == ["layer0/wq", "layer0/ffn_up"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_indices(ns: np.ndarray, cap: int) -> np.ndarray:
    """``_subsample``'s index rule, ``floor(arange(cap) * (n / cap))`` with
    the Python float ``n / cap`` taken as a weak float32, for many ``n`` in
    one jitted JAX computation (one ``_subsample`` call per ``n`` compiles
    anew and takes a tenth of a second)."""
    step = jnp.asarray(ns / cap, jnp.float32)[:, None]
    return np.asarray(jax.jit(lambda s: jnp.floor(
        jnp.arange(cap) * s).astype(jnp.int32))(step))


@pytest.mark.parametrize("cap", [256, 1024, 300])
def test_subsample_indices_match_jax_float32(cap):
    ns = np.arange(cap + 1, 5001)
    want = _jax_indices(ns, cap)
    for n, row in zip(ns, want):
        np.testing.assert_array_equal(monitor.subsample_index(int(n), cap),
                                      row, err_msg=f"n={n}")
    # the rule above is _subsample's own: spot checks through the real
    # function, among them n where float64 picks other rows, and n <= cap
    for n in (1, cap - 1, cap, cap + 1, 312, 1025, 3073, 4999, 5000):
        got = monitor._subsample(torch.arange(n), cap, 0).numpy()
        real = np.asarray(jmonitor._subsample(jnp.arange(n), cap, 0))
        np.testing.assert_array_equal(got, real, err_msg=f"n={n}")


def test_subsample_index_needs_float32():
    """With a cap that is not a power of two the float64 rule picks other
    rows for some n (n = 312 at cap 300 among them): the port's float32
    indices are the JAX package's, not ``floor(i * n / cap)``."""
    differ = [n for n in range(301, 5001)
              if not np.array_equal(
                  monitor.subsample_index(n, 300).numpy(),
                  np.floor(np.arange(300) * (n / 300)).astype(np.int64))]
    assert 312 in differ


def test_stream_counters_and_sampled_scale_match_jax():
    rng = np.random.default_rng(3)
    A = np.maximum(rng.standard_normal((40, 300)), 0).astype(np.float32)
    W = (rng.standard_normal((300, 70)) * 0.05).astype(np.float32)
    mcfg = monitor.MonitorConfig(max_rows=32, max_cols=48, max_depth=256)
    jcfg = jmonitor.MonitorConfig(max_rows=32, max_cols=48, max_depth=256)
    a2, w2 = monitor.subsample_operands(torch.from_numpy(A),
                                        torch.from_numpy(W), mcfg)
    ja2, jw2 = jmonitor.subsample_operands(jnp.asarray(A), jnp.asarray(W),
                                           jcfg)
    np.testing.assert_array_equal(a2.numpy(), np.asarray(ja2))
    got = monitor.stream_counters(a2, w2, mcfg)
    want = jax.device_get(jmonitor.stream_counters(ja2, jw2, jcfg))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    assert (monitor.sampled_fraction_scale(40, 300, 70, mcfg, sampled_m=16)
            == jmonitor.sampled_fraction_scale(40, 300, 70, jcfg,
                                               sampled_m=16))
    energy = monitor.counters_to_energy({k: float(v)
                                         for k, v in got.items()})
    assert energy == jmonitor.counters_to_energy(
        {k: float(v) for k, v in want.items()})


def test_capture_record_and_report_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    lhs = np.maximum(rng.standard_normal((6, 20, 40)), 0).astype(np.float32)
    rhs = (rng.standard_normal((6, 40, 24)) * 0.1).astype(np.float32)
    cap, jcap = TraceCapture(), JCapture()
    for _ in range(5):                           # 4 sampled calls, then 1
        cap.record(MatmulSite("blk/wq", "dot_general",
                              torch.from_numpy(lhs), torch.from_numpy(rhs)))
        jcap.record(JSite("blk/wq", "dot_general", jnp.asarray(lhs),
                          jnp.asarray(rhs)))
    counters = {"e/baseline/total": 10.0, "e/baseline/streaming": 4.0,
                "e/proposed/total": 9.0, "e/proposed/streaming": 3.0,
                "h/baseline": 7.0, "v/baseline": 5.0, "h/proposed": 6.0,
                "v/proposed": 2.0, "zero_fraction": 0.25}
    for c in (cap, jcap):
        c.record_counters("decode/layer0/wq", "dot_general", (3, 1, 64, 32),
                          counters)
    rep = build_report(cap, model="m")
    jrep = jbuild_report(jcap, model="m")
    assert [s.name for s in rep.sites] == [s.name for s in jrep.sites]
    for s, js in zip(rep.sites, jrep.sites):
        assert (s.calls, s.sampled_calls, s.shape, s.macs) == (
            js.calls, js.sampled_calls, js.shape, js.macs)
        for d, comps in js.designs.items():
            for c, v in comps.items():
                np.testing.assert_allclose(s.designs[d][c], v, rtol=1e-6)
    for k, v in jrep.summary().items():
        if isinstance(v, float):
            np.testing.assert_allclose(rep.summary()[k], v, rtol=1e-6)
    rep.to_json(str(tmp_path / "r.json"))
    back = TraceReport.from_json(str(tmp_path / "r.json"))
    assert back.summary() == rep.summary()
    rep.to_csv(str(tmp_path / "r.csv"))
    assert (tmp_path / "r.csv").read_text().count("\n") == 1 + len(rep.sites)
