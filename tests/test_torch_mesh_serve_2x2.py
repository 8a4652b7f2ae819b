"""The port's engines and trainer on a 2x2 mesh: four gloo processes on
the CPU, against the live JAX single-device engine and the port's own
no-mesh runs (``tests/multidevice/test_sharded_serve.py``'s contract;
JAX's multidevice suite proves JAX sharded == JAX unsharded, so these
close the triangle).

On the weights of the JAX package's smoke Qwen1.5-0.5B (float32):

* the slot and paged engines on the mesh (``kernel_backend="auto"``: the
  decode computes ``"ref"``, the accountant its counter passes) give the
  JAX engine's greedy tokens, and bitwise the port's no-mesh ``"ref"``
  run's per-request energies, serve-wide aggregate, slot churn and
  stats;
* greedy rows stay exact beside stochastic co-tenants;
* two trainer steps on the mesh (FSDP over data, TP over model, the
  sequence-parallel residual stream) give the no-mesh losses and
  gradient norms within rtol 1e-5 (float32; the sharded products
  re-associate their sums: 1e-7 apart in practice);
* the checkpoint saved on the 2x2 mesh restores onto 1x4 and takes the
  third step to the no-mesh run's within the same tolerance.

The four processes are spawned once for the module and run every case.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from repro.configs import SMOKES as JSMOKES
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.models import convert

SHAPE = (2, 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = JSMOKES[W.ARCH].with_(compute_dtype="float32")
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    tree = jax.tree.map(lambda p: np.asarray(p.value), jparams,
                        is_leaf=is_param)
    return jcfg, jparams, tree


@pytest.fixture(scope="module")
def jax_tokens(weights):
    jcfg, jparams, _ = weights
    eng = JServeEngine(jparams, jcfg, JServeConfig(
        max_slots=W.MAX_SLOTS, cache_len=W.CACHE_LEN))
    for p, b in zip(W.PROMPTS, W.BUDGETS):
        eng.submit(p, max_new_tokens=b)
    return {r.uid: list(r.generated) for r in eng.run()}


@pytest.fixture(scope="module")
def plain(weights):
    """The port's no-mesh runs."""
    params = convert.params_from_jax(weights[2], W.smoke_cfg())
    return {"slot": W.serve(params, backend="ref"),
            "paged": W.serve(params, paged=True, backend="ref"),
            "stochastic": W.serve(params, power=False, stochastic=True),
            "train3": W.train(steps=3)}


@pytest.fixture(scope="module")
def mesh_runs(weights, tmp_path_factory):
    return W.spawn_cases(str(tmp_path_factory.mktemp("mesh2x2")), SHAPE,
                         weights[2], ("slot", "paged", "stochastic",
                                      "train"))


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_mesh_engine_tokens_equal_the_jax_engine(mesh_runs, jax_tokens,
                                                 engine):
    assert mesh_runs[engine]["tokens"] == jax_tokens


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_mesh_auto_is_bitwise_the_single_device_ref(mesh_runs, plain,
                                                    engine):
    got, want = mesh_runs[engine], plain[engine]
    assert got["tokens"] == want["tokens"]
    assert got["finish"] == want["finish"]
    for uid in want["energy"]:
        assert got["energy"][uid] == want["energy"][uid], uid
    assert got["aggregate"] == want["aggregate"]
    assert got["stats"] == want["stats"]


def test_mesh_slot_churn_equals_single_device(mesh_runs, plain):
    got, want = mesh_runs["slot"], plain["slot"]
    for k in ("order", "slots", "steps", "allocations"):
        assert got[k] == want[k], k
    assert mesh_runs["counts"]["index_write"] > 0


def test_greedy_rows_exact_beside_stochastic_cobatch(mesh_runs, plain):
    got = mesh_runs["stochastic"]["tokens"]
    want = plain["stochastic"]["tokens"]
    for uid in range(0, len(W.PROMPTS), 2):          # the greedy rows
        assert got[uid] == want[uid], uid


def test_mesh_trainer_steps_equal_the_plain_steps(mesh_runs, plain):
    for got, want in zip(mesh_runs["train"], plain["train3"][:2]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_checkpoint_saved_on_2x2_restores_onto_1x4(mesh_runs, plain):
    (got,) = mesh_runs["resumed"]                   # step 2 alone
    assert got["step"] == 2
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], plain["train3"][2][k],
                                   rtol=1e-5)
