"""The port's train step and trainer against the JAX package's, live,
on the smoke Qwen1.5-0.5B (tied, bfloat16 compute) from the JAX
package's initial params and ``opt.init``, carried across by
``models.convert``:

* ``make_train_step`` for 3 steps at ``grad_accum=1`` (with the power
  monitor), at ``grad_accum=2`` and with ``compress=True``, at both
  trainers' default lr, each step from the JAX step's carried params
  and optimiser state: the losses within rtol 1e-2 (at most 3.8e-4
  apart on this CPU), ``grad_norm`` within rtol 2e-2 (5.5e-4), every
  param leaf within relative L2 1e-3 (3.2e-4; 6.3e-4 compressed) and
  the moments within the gradients' 5e-2 (2.9e-2) after every step.
  Adam's normalised step moves a weight by about lr whatever its
  gradient's size, so where the two sides' bf16 gradients differ in
  sign near zero (or, compressed, in their int8 level) the weights
  part by up to 2 lr: the params' difference grows with lr (1.3e-3
  at lr 2e-3). The biases start at zero, so they are a few lr at most
  and a flipped sign is a large share of them (``bk``'s gradient is
  zero in exact arithmetic, as a query's softmax ignores a constant
  added to all its scores, and is rounding noise on both sides): they
  are held elementwise within 2 lr;
* ``_monitor_metrics`` on the JAX step's own updated params and batch:
  the same keys, every metric within rtol 1e-6 (equal here: the
  counters are integers, and the pricing rounds alike at this size);
* ``train`` with the power monitor and a power trace every 2 steps: the
  loss histories within rtol 1e-2 (at most 8.2e-4), the traces at the
  same steps over the same number of sites, their streaming savings
  within 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.optim import adamw as jadamw
from repro_torch.configs import SMOKES
from repro_torch.launch import train as T
from repro_torch.models import convert, lm
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

ARCH = "qwen1.5-0.5b"
LR = 3e-4          # both trainers' default
LOSS_RTOL = 1e-2
GNORM_RTOL = 2e-2
PARAM_RL2 = 1e-3
STATE_RL2 = 5e-2
MONITOR_RTOL = 1e-6
STEP_CASES = {"accum1": dict(grad_accum=1, monitor=True),
              "accum2": dict(grad_accum=2),
              "compress": dict(compress=True)}


def _values(tree):
    return jax.tree.map(lambda p: np.asarray(p.value), tree, is_leaf=is_param)


@pytest.fixture(scope="module")
def qwen():
    jcfg, cfg = JSMOKES[ARCH], SMOKES[ARCH]
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    src = JSyntheticLM(jcfg, JDataConfig(seq_len=32, global_batch=4, seed=5))
    return jcfg, cfg, jparams, [src.batch(i) for i in range(3)]


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp(min=1e-30))


def _monitor_close(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=MONITOR_RTOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(qwen, case):
    jcfg, cfg, jparams, batches = qwen
    kw = dict(STEP_CASES[case])
    compress = kw.pop("compress", False)
    jopt = jadamw.AdamW(lr=LR, compress=compress)
    opt = adamw.AdamW(lr=LR, compress=compress)
    jstep = jax.jit(jlm.make_train_step(jcfg, jopt, **kw))
    step = lm.make_train_step(cfg, opt, **kw)
    jp, jst = jparams, jopt.init(jparams)
    init = tree_leaves(convert.params_from_jax(_values(jparams), cfg))
    for i, batch in enumerate(batches):
        # each step from the JAX package's carried params and state
        tp = convert.params_from_jax(_values(jp), cfg)
        tst = convert.opt_state_from_jax(_values(jst), cfg)
        assert (tst.err is None) == (not compress)
        jp, jst, jm = jstep(jp, jst, jax.tree.map(jnp.asarray, batch),
                            jnp.int32(i))
        tbatch = T.batch_to(batch, "cpu")
        tp, tst, tm = step(tp, tst, tbatch, i)
        assert sorted(tm) == sorted(jm)
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=f"{i} {k}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GNORM_RTOL)
        want = convert.params_from_jax(_values(jp), cfg)
        for got, w, w0 in zip(tree_leaves(tp), tree_leaves(want), init):
            assert got.dtype == torch.float32
            if w0.abs().max() > 0:
                assert _rel_l2(got, w) <= PARAM_RL2, (case, i)
            else:
                # the zero-initialised biases: see the module doc
                assert float((got - w).abs().max()) <= 2 * LR
        # the moments carried out of the step, within the gradients'
        # bf16 tolerance; the compression residuals part by a whole
        # quantisation level where the two sides' gradients straddle a
        # rounding boundary, so only their layout is held
        wst = convert.opt_state_from_jax(_values(jst), cfg)
        assert (tst.err is None) == (wst.err is None)
        for got, w in zip(tree_leaves(tst), tree_leaves(wst)):
            assert got.dtype == torch.float32 and got.shape == w.shape
        for got, w in zip(tree_leaves((tst.m, tst.v)),
                          tree_leaves((wst.m, wst.v))):
            assert _rel_l2(got, w) <= STATE_RL2, (case, i)
        if kw.get("monitor"):
            # the port's monitor on the JAX step's own updated params
            power = {k: v for k, v in jm.items() if k.startswith("power/")}
            _monitor_close(lm._monitor_metrics(want, cfg, tbatch), power,
                           f"step {i}")


def test_trainer_matches_jax(qwen, monkeypatch):
    """``train`` with the monitor and a trace every 2 steps, the port's
    ``init_state`` returning the JAX package's initial state."""
    jcfg, cfg, jparams, _ = qwen
    kw = dict(arch=ARCH, smoke=True, steps=4, seq=32, batch=2,
              power_monitor=True, power_trace_every=2)
    want = jtrain.train(jtrain.TrainConfig(**kw))
    jopt = jadamw.AdamW()

    def init_state(cfg_, opt, device, seed, mesh=None):
        assert seed == 0 and mesh is None
        assert dataclasses.asdict(cfg_) == dataclasses.asdict(cfg)
        return (convert.params_from_jax(_values(jparams), cfg, device),
                convert.opt_state_from_jax(_values(jopt.init(jparams)),
                                           cfg, device))

    monkeypatch.setattr(T, "init_state", init_state)
    got = T.train(T.TrainConfig(**kw, device="cpu"))
    assert [h["step"] for h in got["history"]] == [0, 1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=LOSS_RTOL)
    for h in got["history"]:
        assert np.isfinite(h["grad_norm"]) and "power/saving_total" in h
    assert ([(t["step"], t["n_sites"]) for t in got["power_traces"]]
            == [(t["step"], t["n_sites"]) for t in want["power_traces"]]
            == [(0, 19), (2, 19)])
    for g, w in zip(got["power_traces"], want["power_traces"]):
        assert g["model"] == w["model"]
        np.testing.assert_allclose(g["streaming_saving"],
                                   w["streaming_saving"], atol=1e-3)
