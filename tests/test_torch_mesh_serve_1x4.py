"""The port's slot and paged engines on a 1x4 mesh (tensor parallel
only: four gloo processes on the CPU), against the live JAX
single-device engine and the port's no-mesh ``"ref"`` runs, as
``tests/test_torch_mesh_serve_2x2.py`` holds the 2x2 mesh: the JAX
engine's greedy tokens, and bitwise the no-mesh energies, aggregate and
stats (the accountant streams gathered operands). A 1x2 mesh over the
first two of the four ranks serves the same tokens while the other two
sit out, and no rank hangs.
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

SHAPE = (1, 4)


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
    params = convert.params_from_jax(weights[2], W.smoke_cfg())
    return {"slot": W.serve(params, backend="ref"),
            "paged": W.serve(params, paged=True, backend="ref")}


@pytest.fixture(scope="module")
def mesh_runs(weights, tmp_path_factory):
    return W.spawn_cases(str(tmp_path_factory.mktemp("mesh1x4")), SHAPE,
                         weights[2], ("slot", "paged", "subset"))


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_mesh_engine_tokens_equal_the_jax_engine(mesh_runs, jax_tokens,
                                                 engine):
    assert mesh_runs[engine]["tokens"] == jax_tokens


@pytest.mark.parametrize("engine", ["slot", "paged"])
def test_mesh_auto_is_bitwise_the_single_device_ref(mesh_runs, plain,
                                                    engine):
    got, want = mesh_runs[engine], plain[engine]
    assert got["tokens"] == want["tokens"]
    for uid in want["energy"]:
        assert got["energy"][uid] == want["energy"][uid], uid
    assert got["aggregate"] == want["aggregate"]
    assert got["stats"] == want["stats"]
    for k in ("order", "slots", "steps", "allocations"):
        assert got[k] == want[k], k


def test_subset_mesh_serves_while_the_other_ranks_sit_out(mesh_runs,
                                                           jax_tokens):
    assert mesh_runs["subset"]["tokens"] == jax_tokens
