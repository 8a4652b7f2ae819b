"""The port's training loss and its gradients against the JAX package's
``loss_fn`` and ``jax.value_and_grad``, live, on the same weights
(carried across by ``models.convert``) and ``SyntheticLM`` batches: the
tied dense LM (Qwen1.5-0.5B), the MoE with its load-balancing ``aux``
(Phi-3.5-MoE), the RG-LRU scan with local attention (RecurrentGemma-9B),
embeds with M-RoPE positions (Qwen2-VL-72B) and codes (MusicGen-medium),
each at its smoke config.

Tolerances, measured on this CPU beside their ceilings:

* float32 compute: the loss within rtol 1e-6 (at most 1.6e-7 apart),
  every gradient leaf within relative L2 1e-5 (at most 1.5e-6);
* the configs' bfloat16: the loss within rtol 2e-3 (at most 4.6e-4),
  every gradient leaf within relative L2 5e-2 (at most 2.7e-2, the
  MoE's): the jitted JAX step fuses and rounds bf16 apart from the
  port's eager ops, and the backward carries it through every layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro_torch.configs import SMOKES
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.train import batch_to
from repro_torch.models import convert, lm
from repro_torch.tree import tree_leaves, tree_unflatten

ARCHS = ("qwen1.5-0.5b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b",
         "qwen2-vl-72b", "musicgen-medium")
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 2e-3}
GRAD_RL2 = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(tree):
    return jax.tree.map(lambda p: np.asarray(p.value), tree, is_leaf=is_param)


def _setup(arch, dt, seq=32):
    jcfg = JSMOKES[arch].with_(compute_dtype=dt)
    cfg = SMOKES[arch].with_(compute_dtype=dt)
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    params = convert.params_from_jax(_values(jparams), cfg)
    d = dict(seq_len=seq, global_batch=2, seed=1)
    batch = JSyntheticLM(jcfg, JDataConfig(**d)).batch(0)
    tbatch = SyntheticLM(cfg, DataConfig(**d)).batch(0)
    for k in batch:
        np.testing.assert_array_equal(tbatch[k], batch[k])
    return jcfg, jparams, cfg, params, batch


def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    want = torch.from_numpy(np.asarray(want, np.float64))
    return float((got.double() - want).norm() / want.norm().clamp(min=1e-30))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, dt):
    jcfg, jparams, cfg, params, batch = _setup(arch, dt)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, batch))
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, m = lm.loss_fn(tree_unflatten(params, leaves), cfg,
                         batch_to(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL[dt], err_msg=k)
    if arch.startswith("phi"):
        assert float(m["aux"].detach()) > 0.0
    want = tree_leaves(convert.params_from_jax(_values(jgrads), cfg))
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        if not w.abs().max() > 0:
            assert not g.abs().max() > 0, i
            continue
        assert _rel_l2(g, w.numpy()) <= GRAD_RL2[dt], (i, _rel_l2(g, w))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "musicgen-medium"])
def test_chunked_ce_crosses_a_chunk_boundary_and_pads(arch):
    """``chunk=8`` at S = 30: four chunks, the last padded by 2, with a
    mask that drops some positions; float32, against the JAX function on
    the same hidden states, targets and mask."""
    jcfg, jparams, cfg, params, _ = _setup(arch, "float32")
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 30, cfg.d_model)).astype(np.float32)
    shape = (2, cfg.codebooks, 30) if cfg.inputs == "codes" else (2, 30)
    targets = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    mask = (rng.random((2, 30)) > 0.2).astype(np.float32)
    want = jlm._chunked_ce(jparams, jcfg, jnp.asarray(h),
                           jnp.asarray(targets), jnp.asarray(mask), chunk=8)
    got = lm._chunked_ce(params, cfg, torch.from_numpy(h),
                         torch.from_numpy(targets).long(),
                         torch.from_numpy(mask), chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    whole = lm._chunked_ce(params, cfg, torch.from_numpy(h),
                           torch.from_numpy(targets).long(),
                           torch.from_numpy(mask), chunk=512)
    np.testing.assert_allclose(float(got), float(whole), rtol=1e-6)
