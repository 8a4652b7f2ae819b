"""The port's slot serving engine (``repro_torch.serve``) against the live
JAX engine at smoke size (float32 compute, 3 slots, cache 48, power
accounting on), on the same weights and prompts.

The port runs ``kernel_backend="auto"`` on the CPU (the kernels' plain
versions, the fused decode-counter producer) against the JAX engine's
``kernel_backend="pallas"`` (its Pallas kernels in interpret mode):

* greedy tokens are equal per request under slot churn;
* per-request energies and ``trace_report()`` aggregates agree within
  rtol 1e-6;

and on the port alone, as ``tests/test_serve_engine.py`` pins the JAX
engine: FIFO admission, EOS retirement, infeasible-request rejection,
``power_sample_every`` extrapolation, greedy rows unaffected by stochastic
neighbours, and the plain and fused counter producers feeding the one
assembler to bitwise-equal energies.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import SMOKES
from repro_torch.core import monitor
from repro_torch.kernels.zvg_matmul import kernel as kz
from repro_torch.models import convert
from repro_torch.serve import (PagedServeEngine, PagingConfig,
                               SamplingParams, ServeConfig, ServeEngine, power)

ARCH = "qwen1.5-0.5b"
CACHE_LEN = 48


def _prompts(n, seed, lo=2, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def model():
    jcfg = JSMOKES[ARCH].with_(compute_dtype="float32")
    cfg = SMOKES[ARCH].with_(compute_dtype="float32")
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    tree = jax.tree.map(lambda p: np.asarray(p.value), jparams,
                        is_leaf=is_param)
    return jcfg, jparams, cfg, convert.params_from_jax(tree, cfg)


def _engine(model, **kw):
    _, _, cfg, params = model
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("device", "cpu")
    return ServeEngine(params, cfg, ServeConfig(**kw))


def _drain(engine, prompts, max_new=5, sampling=None):
    for i, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=max_new,
                      **({"sampling": sampling[i]} if sampling else {}))
    done = {r.uid: r for r in engine.run()}
    assert len(done) == len(prompts)
    return done


@pytest.fixture(scope="module")
def against_jax(model):
    """8 greedy requests through 3 slots on both engines."""
    jcfg, jparams, _, _ = model
    prompts = _prompts(8, seed=11)
    jeng = JServeEngine(jparams, jcfg, JServeConfig(
        max_slots=3, cache_len=CACHE_LEN, power_monitor=True,
        kernel_backend="pallas"))
    eng = _engine(model, max_slots=3, power_monitor=True)
    return _drain(jeng, prompts), _drain(eng, prompts), jeng, eng


def test_greedy_tokens_equal_jax_under_churn(against_jax):
    jdone, done, jeng, eng = against_jax
    assert {u: r.generated for u, r in done.items()} == {
        u: r.generated for u, r in jdone.items()}
    assert eng.cache.allocations == jeng.cache.allocations == 8
    assert ({u: (r.slot, r.start_step, r.finish_step)
             for u, r in done.items()}
            == {u: (r.slot, r.start_step, r.finish_step)
                for u, r in jdone.items()})


def test_request_energies_match_jax(against_jax):
    jdone, done, _, _ = against_jax
    for uid, jr in jdone.items():
        r = done[uid].power
        assert (r.decode_steps, r.sampled_steps, r.sites) == (
            jr.power.decode_steps, jr.power.sampled_steps, jr.power.sites)
        assert r.energy.keys() == jr.power.energy.keys()
        for d, comps in jr.power.energy.items():
            for c, v in comps.items():
                np.testing.assert_allclose(r.energy[d][c], v, rtol=1e-6,
                                           err_msg=f"{uid} {d}/{c}")
        np.testing.assert_allclose(r.zero_fraction,
                                   jr.power.zero_fraction, rtol=1e-6)


def test_trace_report_matches_jax(against_jax):
    _, _, jeng, eng = against_jax
    rep, jrep = eng.trace_report(), jeng.trace_report()
    assert [s.name for s in rep.sites] == [s.name for s in jrep.sites]
    assert [(s.calls, s.shape, s.macs) for s in rep.sites] == [
        (s.calls, s.shape, s.macs) for s in jrep.sites]
    for s, js in zip(rep.sites, jrep.sites):
        for d, comps in js.designs.items():
            for c, v in comps.items():
                np.testing.assert_allclose(s.designs[d][c], v, rtol=1e-6)
    got, want = rep.summary(), jrep.summary()
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        sum(s.energy("baseline") for s in rep.sites),
        sum(r.power.energy["baseline"]["total"]
            for r in against_jax[1].values()), rtol=1e-6)


def test_producers_feed_one_assembler_bitwise(model):
    """kernel_backend="auto" (the fused producer) and "ref" (the plain
    producer through the counter pass) give bitwise-equal tokens,
    energies and reports, greedy and stochastic rows alike."""
    prompts = _prompts(6, seed=5)
    sampling = [SamplingParams() if i % 2 == 0
                else SamplingParams(temperature=0.8, top_k=5)
                for i in range(6)]
    runs = [_drain(_engine(model, max_slots=3, power_monitor=True, seed=3,
                           kernel_backend=b), prompts, sampling=sampling)
            for b in ("auto", "ref")]
    for uid, r in runs[0].items():
        assert r.generated == runs[1][uid].generated
        assert r.power.energy == runs[1][uid].power.energy
        assert r.power.zero_fraction == runs[1][uid].power.zero_fraction


def test_decode_counter_producers_are_bitwise_equal(model):
    _, _, cfg, params = model
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    A[1] = 0.0
    W = params["layers"][0]["ffn"]["up"]
    mcfg = monitor.MonitorConfig(max_cols=100)
    fused = power._fused_decode_counters(A, W, mcfg, "auto")
    plain = power._ref_decode_counters(A, W, mcfg)
    for f, p in zip(fused[:4], plain):
        assert torch.equal(f, p)
    assert power.fused_decode_supported(mcfg)
    rows = power._assemble_decode(*plain, mcfg, 100)
    assert all(v.shape == (3,) for v in rows.values())
    # each row priced on its own gives the same numbers
    solo = power._rows_counters(A, W, mcfg)
    for k, v in rows.items():
        np.testing.assert_allclose(v.numpy(), solo[k].numpy(), rtol=1e-6,
                                   err_msg=k)


def test_greedy_rows_unaffected_by_stochastic_neighbors(model):
    prompts = _prompts(4, seed=7)
    solo = _drain(_engine(model, max_slots=1), prompts[:1])[0].generated
    eng = _engine(model, max_slots=4, seed=3)
    eng.submit(prompts[0], max_new_tokens=5)
    for p in prompts[1:]:
        eng.submit(p, max_new_tokens=5,
                   sampling=SamplingParams(temperature=1.2, top_k=7))
    done = {r.uid: r for r in eng.run()}
    assert done[0].generated == solo
    assert all(0 <= t < 256 for r in done.values() for t in r.generated)


def test_fifo_admission_and_slot_reuse(model):
    eng = _engine(model, max_slots=2)
    done = _drain(eng, _prompts(5, seed=8), max_new=3)
    starts = [done[u].start_step for u in sorted(done)]
    assert starts == sorted(starts)
    assert eng.cache.allocations == 5 and eng.stats["peak_live"] <= 2
    assert {r.slot for r in done.values()} <= {0, 1}
    assert eng.cache.n_free == 2


def test_eos_retires_early(model):
    prompt = _prompts(1, seed=9)[0]
    toks = _drain(_engine(model, max_slots=1), [prompt], max_new=6)[0]
    eos = toks.generated[2]
    stop = toks.generated.index(eos)
    (r,) = _drain(_engine(model, max_slots=1, eos_id=eos), [prompt],
                  max_new=6).values()
    assert r.finish_reason == "eos"
    assert r.generated == toks.generated[:stop + 1]


def test_infeasible_requests_rejected_and_cancel(model):
    eng = _engine(model, max_slots=1)
    with pytest.raises(ValueError, match="cache"):
        eng.submit(list(range(40)), max_new_tokens=CACHE_LEN)
    with pytest.raises(ValueError):
        eng.submit([], max_new_tokens=1)
    with pytest.raises(ValueError):
        eng.submit([1, 2], max_new_tokens=0)
    a = eng.submit([1, 2, 3], max_new_tokens=2)
    b = eng.submit([4, 5], max_new_tokens=2)
    assert eng.cancel(b.uid) and not eng.cancel(b.uid)
    assert b.finish_reason == "cancelled"
    assert [r.uid for r in eng.run()] == [a.uid]


def test_power_sample_every_extrapolates(model):
    eng = _engine(model, max_slots=2, power_monitor=True,
                  power_sample_every=3)
    done = _drain(eng, _prompts(3, seed=10), max_new=8)
    r = done[0].power
    assert r.decode_steps == 7 and r.sampled_steps == 3   # steps 0, 3, 6
    assert r.energy["baseline"]["total"] > 0
    rep = eng.trace_report()
    np.testing.assert_allclose(
        sum(s.energy("baseline") for s in rep.sites),
        sum(q.power.energy["baseline"]["total"] for q in done.values()),
        rtol=1e-6)


def test_cpu_run_launches_no_kernel_and_config_is_checked(model):
    before = kz.gated_row_matmul_cuda.launches
    _drain(_engine(model, max_slots=2), _prompts(2, seed=12), max_new=3)
    assert kz.gated_row_matmul_cuda.launches == before
    with pytest.raises(ValueError, match="kernel_backend"):
        ServeConfig(kernel_backend="pallas", device="cpu")
    assert isinstance(_engine(model, paging=PagingConfig(page_size=8)),
                      PagedServeEngine)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(model, telemetry=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        ServeEngine(model[3], model[2], ServeConfig(device="cpu"),
                    mesh=object())
    with pytest.raises(ValueError, match="CUDA tensors"):
        _drain(_engine(model, kernel_backend="cuda"), [[1, 2, 3]])


def test_serve_config_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    assert dataclasses.fields(ServeConfig)[-3].name == "device"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeConfig(device="cuda")
