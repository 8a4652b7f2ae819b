"""The training support of the port against the JAX package, live: the
data pipeline (batches bitwise for every input kind), the optimiser
(``cosine_schedule``, ``global_norm``, the clip and ``AdamW.update``
within rtol 1e-6 on the same numpy inputs; ``compress_with_feedback``
bitwise against the eager JAX function); then the port alone: the
checkpointer, the fault tools, the trainer's refusals, resume
equivalence (bitwise on the CPU), and the tied embedding's gradient.

Tolerances: the schedule, the norm and the optimiser's outputs part
from JAX's by 2-7e-7 relative (float32 ``cos``, ``pow`` and the norm's
summation order round apart by an ulp or two; the update squares the
clip scale into ``v``), so they are held at rtol 1e-6. The quantiser
is elementwise and divides by a tensor, so it is bitwise; the jitted
JAX function fuses ``g - q * scale`` and rounds apart, so the eager one
is the reference.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.data import pipeline as jdata
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import SMOKES
from repro_torch.data import pipeline as data
from repro_torch.launch import train as T
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import fault
from repro_torch.tree import tree_leaves, tree_unflatten

OPT_RTOL = 1e-6


def _tt(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got: torch.Tensor, want, rtol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=0, err_msg=what)


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-vl-72b",
                                  "musicgen-medium"])
def test_synthetic_batches_are_the_jax_packages_bitwise(arch):
    """Tokens, embeds with positions and labels, and codes: every leaf
    of every step equal in dtype, shape and bits, host shards too."""
    for kw in ({}, {"host_index": 1, "host_count": 2}):
        d = dict(seq_len=24, global_batch=4, seed=7, **kw)
        jsrc = jdata.SyntheticLM(JSMOKES[arch], jdata.DataConfig(**d))
        src = data.SyntheticLM(SMOKES[arch], data.DataConfig(**d))
        for step in (0, 3, 11):
            jb, tb = jsrc.batch(step), src.batch(step)
            assert sorted(jb) == sorted(tb)
            for k in jb:
                assert jb[k].dtype == tb[k].dtype, k
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_token_file_source_is_the_jax_packages_bitwise(tmp_path):
    toks = (np.arange(10000) * 7919 % 65521).astype(np.uint16)
    path = str(tmp_path / "toks.bin")
    toks.tofile(path)
    for kw in ({}, {"host_index": 1, "host_count": 2}):
        d = dict(seq_len=16, global_batch=4, **kw)
        jsrc = jdata.make_source(JSMOKES["qwen1.5-0.5b"],
                                 jdata.DataConfig(**d), path)
        src = data.make_source(SMOKES["qwen1.5-0.5b"],
                               data.DataConfig(**d), path)
        assert isinstance(src, data.TokenFileSource)
        for step in (0, 1, 57):
            np.testing.assert_array_equal(src.batch(step)["tokens"],
                                          jsrc.batch(step)["tokens"])
    assert int(src.batch(0)["tokens"].max()) < SMOKES["qwen1.5-0.5b"].vocab


def test_host_sharding_partitions_the_batch():
    cfg = SMOKES["qwen1.5-0.5b"]
    full = data.SyntheticLM(cfg, data.DataConfig(seq_len=8, global_batch=4))
    shards = [data.SyntheticLM(cfg, data.DataConfig(
        seq_len=8, global_batch=4, host_index=i, host_count=2))
        for i in range(2)]
    assert full.batch(0)["tokens"].shape == (4, 8)
    b = [s.batch(0)["tokens"] for s in shards]
    assert all(x.shape == (2, 8) for x in b)
    assert not np.array_equal(b[0], b[1])
    np.testing.assert_array_equal(shards[0].batch(5)["tokens"],
                                  shards[0].batch(5)["tokens"])


# ------------------------------------------------------------ optimiser
def test_cosine_schedule_matches_jax_at_every_step():
    for peak, warmup, total in ((1e-3, 10, 100), (3e-4, 0, 7),
                                (2e-3, 5, 5)):
        steps = np.arange(total + 1, dtype=np.int32)
        want = jax.vmap(jadamw.cosine_schedule(peak, warmup, total))(
            jnp.asarray(steps))
        got = adamw.cosine_schedule(peak, warmup, total)(
            torch.from_numpy(steps))
        assert got.dtype == torch.float32
        _close(got, want, OPT_RTOL, f"{(peak, warmup, total)}")
    lr = adamw.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-5)


def _opt_tree(rng, scale=1.0, positive=False):
    def leaf(*shape):
        x = rng.standard_normal(shape)
        return ((np.abs(x) + 0.5 if positive else x) * scale
                ).astype(np.float32)
    return {"w": leaf(48, 40), "blocks": [{"up": leaf(40, 24)},
                                          {"up": leaf(40, 24)}],
            "norm": {"scale": leaf(40)}}


def test_global_norm_and_the_clip_match_jax():
    rng = np.random.default_rng(1)
    g = _opt_tree(rng, 3.0)
    _close(adamw.global_norm(_tt(g)), jadamw.global_norm(g), OPT_RTOL,
           "global_norm")
    # the clip alone: plain Adam moments at step 0 are the clipped grads
    jopt, opt = jadamw.AdamW(b1=0.0, b2=0.0), adamw.AdamW(b1=0.0, b2=0.0)
    params = _opt_tree(rng)
    _, jst = jopt.update(g, jopt.init(params), params, jnp.int32(0))
    _, st = opt.update(_tt(g), opt.init(_tt(params)), _tt(params),
                       torch.tensor(0, dtype=torch.int32))
    for got, want in zip(tree_leaves(st.m), jax.tree.leaves(jst.m)):
        _close(got, want, OPT_RTOL, "clipped grads")
    assert float(adamw.global_norm(st.m)) == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_jax(compress):
    """Four steps on the same grads and params under a warmup schedule:
    updates, ``m``, ``v`` (and ``err``) within rtol 1e-6 each step, with
    the params carried on each side. Params and grads are positive, so
    no sum in the update cancels: a cancelling sum would turn the clip
    scale's last-ulp difference (the norm's summation order) into any
    relative difference at all."""
    rng = np.random.default_rng(2)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 10),
                        compress=compress)
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 10),
                      compress=compress)
    jp = jax.tree.map(jnp.asarray, _opt_tree(rng, positive=True))
    tp = _tt(jp)
    jst, st = jopt.init(jp), opt.init(tp)
    assert (st.err is None) == (not compress)
    for step in range(4):
        # clipped, then not; under compression always clipped, so the
        # carried residual stays small beside the grads and keeps them
        # positive
        small = step % 2 and not compress
        g = _opt_tree(rng, 0.005 if small else 3.0, positive=True)
        ju, jst = jopt.update(g, jst, jp, jnp.int32(step))
        tu, st = opt.update(_tt(g), st, tp, torch.tensor(step,
                                                         dtype=torch.int32))
        pairs = [(tu, ju), (st.m, jst.m), (st.v, jst.v)]
        if compress:
            pairs.append((st.err, jst.err))
        for k, (got, want) in enumerate(pairs):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                assert a.dtype == torch.float32
                _close(a, b, OPT_RTOL, f"step {step} part {k}")
        jp = jax.tree.map(jnp.add, jp, ju)
        tp = tree_unflatten(tp, [a + b for a, b in zip(tree_leaves(tp),
                                                       tree_leaves(tu))])


def test_compress_with_feedback_is_bitwise_the_jax_function():
    rng = np.random.default_rng(3)
    g = _opt_tree(rng, 2.0)
    err = _opt_tree(rng, 0.01)
    g["tiny"] = np.zeros(5, np.float32)       # the 1e-12 floor of the scale
    err["tiny"] = np.zeros(5, np.float32)
    jg, je = jadamw.compress_with_feedback(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, err))
    tg, te = adamw.compress_with_feedback(_tt(g), _tt(err))
    for got, want in zip(tree_leaves(tg) + tree_leaves(te),
                         jax.tree.leaves(jg) + jax.tree.leaves(je)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compression_error_feedback_preserves_the_sum():
    """The delivered gradients plus the residual sum to the true ones
    within one quantisation step, whatever the number of steps."""
    rng = np.random.default_rng(0)
    true = [torch.from_numpy(rng.standard_normal(32).astype(np.float32))
            for _ in range(5)]
    err = {"g": torch.zeros(32)}
    delivered = torch.zeros(32)
    for g in true:
        out, err = adamw.compress_with_feedback({"g": g}, err)
        delivered = delivered + out["g"]
    assert float((delivered + err["g"] - sum(true)).abs().max()) < 1e-4


# ----------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_keeps_dtypes_and_structure(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": [torch.randn(4), torch.randn(3).to(torch.bfloat16)],
            "state": adamw.AdamWState(m={"x": torch.ones(2)},
                                      v={"x": torch.full((2,), 2.0)},
                                      err=None)}
    ck.save(3, tree)
    assert ck.latest_step() == 3
    target = {"a": torch.zeros(2, 3, dtype=torch.int64),
              "b": [torch.zeros(4), torch.zeros(3, dtype=torch.bfloat16)],
              "state": adamw.AdamWState(m={"x": torch.zeros(2)},
                                        v={"x": torch.zeros(2)}, err=None)}
    out = ck.restore(3, target)
    assert isinstance(out["state"], adamw.AdamWState)
    assert out["state"].err is None
    for got, want in zip(tree_leaves(out), tree_leaves(tree)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # onto the target's dtype: a float32 target takes the bf16 bits widened
    out = ck.restore(3, {**target, "b": [torch.zeros(4), torch.zeros(3)]})
    assert out["b"][1].dtype == torch.float32
    assert torch.equal(out["b"][1], tree["b"][1].float())


def test_checkpoint_async_save_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    x = torch.ones(8)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": x.fill_(float(s))})
    x.fill_(-1.0)                     # the save copied the leaves at once
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert ck.latest_step() == 4
    assert float(ck.restore(4, {"x": x})["x"][0]) == 4.0
    assert ck.restore_latest({"x": x})[0] == 4


def test_checkpoint_structure_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(0, {"x": torch.ones(4)})
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore(0, {"x": torch.ones(5)})
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore(0, {"x": torch.ones(4), "y": torch.ones(1)})


def test_checkpoint_tmp_is_never_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    assert ck.restore_latest({"x": torch.ones(2)}) == (None, None)
    ck.save(7, {"x": torch.ones(2)})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")   # a crash mid-write
    assert ck.latest_step() == 7


# ---------------------------------------------------------------- fault
def test_step_timer_flags_stragglers(monkeypatch):
    # a scripted clock: a sleep overruns by milliseconds on a loaded
    # machine, which made a 2 ms step a straggler
    clock = {"t": 0.0}
    monkeypatch.setattr(fault, "time", types.SimpleNamespace(
        perf_counter=lambda: clock["t"]))
    t = fault.StepTimer(straggler_factor=1.5, device="cpu")
    for i in range(6):
        t.start()
        clock["t"] += 0.002
        t.stop(i)
    t.start()
    clock["t"] += 0.05
    t.stop(99)
    assert t.straggler_steps == [99]
    assert 0.0015 < t.median < 0.05


def test_run_with_restarts_recovers():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return "ok"

    assert fault.run_with_restarts(flaky, max_restarts=5) == "ok"
    assert calls["n"] == 3


def test_run_with_restarts_gives_up():
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise RuntimeError("nope")

    with pytest.raises(RuntimeError, match="nope"):
        fault.run_with_restarts(always, max_restarts=2)
    assert calls["n"] == 3


# -------------------------------------------------------------- trainer
_TINY = dict(arch="qwen1.5-0.5b", smoke=True, seq=32, batch=2, seed=3,
             device="cpu")


def test_trainer_refuses_a_mesh_and_model_parallelism():
    with pytest.raises(NotImplementedError, match="queue 1 step 7"):
        T.train(T.TrainConfig(**_TINY, steps=1, model_parallel=2))
    with pytest.raises(NotImplementedError, match="queue 1 step 7"):
        T.train(T.TrainConfig(**_TINY, steps=1), mesh=object())


def test_trainer_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    assert T.TrainConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.train(T.TrainConfig(arch="qwen1.5-0.5b", smoke=True, steps=1))


def test_train_resume_equivalence_is_bitwise(tmp_path):
    """A run stopped after 3 steps and resumed from its checkpoint to 6
    ends on the uninterrupted run's params, moments and losses, bit for
    bit (deterministic data, exact float32 state in the checkpoint)."""
    full = T.train(T.TrainConfig(**_TINY, steps=6, ckpt_every=2,
                                 ckpt_dir=str(tmp_path / "a")))
    first = T.train(T.TrainConfig(**_TINY, steps=3, ckpt_every=2,
                                  ckpt_dir=str(tmp_path / "b")))
    part2 = T.train(T.TrainConfig(**_TINY, steps=6, ckpt_every=2,
                                  ckpt_dir=str(tmp_path / "b")))
    assert [h["step"] for h in part2["history"]] == [3, 4, 5]
    assert ([h["loss"] for h in first["history"] + part2["history"]]
            == [h["loss"] for h in full["history"]])
    assert part2["final_loss"] == full["final_loss"]
    assert full["history"][-1]["loss"] < full["history"][0]["loss"]
    cfg, opt, _ = T.build(T.TrainConfig(**_TINY))
    target = T.init_state(cfg, opt, "cpu", 0)
    a = Checkpointer(str(tmp_path / "a")).restore(5, target)
    b = Checkpointer(str(tmp_path / "b")).restore(5, target)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_tied_embedding_gradient_is_the_float32_sum_of_its_two_uses():
    """bf16 compute, tied head: the gradient of the float32 embedding is
    the float32 sum of the lookup's and the head's bf16 cotangents, each
    widened on its own (one cast a use, as in the JAX package), which is
    not what one shared bf16 cast would give."""
    cfg = SMOKES["qwen1.5-0.5b"]
    assert cfg.tie_embeddings and cfg.compute_dtype == "bfloat16"
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    src = data.SyntheticLM(cfg, data.DataConfig(seq_len=32, global_batch=2))
    batch = T.batch_to(src.batch(0), "cpu")
    embed = params["embed"].detach().requires_grad_()
    loss, _ = lm.loss_fn({**params, "embed": embed}, cfg, batch)
    (g,) = torch.autograd.grad(loss, [embed])

    lookup = params["embed"].to(torch.bfloat16).requires_grad_()
    head = params["embed"].to(torch.bfloat16).requires_grad_()
    w = lm.compute_weights(params, cfg, head=False)
    h, _, aux = lm.apply_model({**w, "embed": lookup}, cfg, batch["tokens"])
    ce = lm._chunked_ce({"embed": head}, cfg, h[:, :-1],
                        batch["tokens"][:, 1:], torch.ones(2, 31))
    assert torch.equal(ce + 0.01 * aux, loss.detach())
    g_lookup, g_head = torch.autograd.grad(ce + 0.01 * aux, [lookup, head])
    assert torch.equal(g, g_lookup.float() + g_head.float())
    assert not torch.equal(g, (g_lookup + g_head).float())
