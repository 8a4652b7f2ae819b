"""The port's sharding rules, meshes, shapes and FLOP model
(``repro_torch.runtime.sharding``, ``launch.mesh``, ``configs.shapes``,
``launch.flops``, ``models.lm.param_axes``) against the JAX package's.

* every arch's ``param_axes`` equals the JAX ``Param.axes``, leaf for
  leaf, in the converted layout (the scanned groups' leading "layers"
  axis dropped);
* ``spec_for`` equals the JAX ``spec_for`` for every parameter of every
  arch on 1x1, 2x2, 1x8, 2x4, 2x2x2 (pod/data/model), 16x16 and 2x16x16
  meshes, under both rule sets (the JAX rules read only the mesh's axis
  names and shape, so a duck-typed mesh drives them);
* ``tests/multidevice/test_sharding_rules.py``'s cases on meshes of a
  fake-backend process group: every rule on every mesh, the serve rules,
  the greedy prefix, the cache layouts, the divisibility fallback and the
  never-reuse / always-divide property; the composed ``("pod", "data")``
  axes shard major to minor, as JAX lays them out;
* ``make_host_mesh`` keeps the JAX fallback rules;
* ``input_specs`` gives the JAX shapes and dtypes for every (arch,
  shape); ``param_counts`` and ``model_flops`` equal JAX's.
"""
import types

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import SMOKES as JSMOKES
from repro.configs import input_specs as jinput_specs
from repro.launch import flops as JF
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.runtime import sharding as jsh
from repro_torch.configs import ARCHS, SHAPES, SMOKES, input_specs
from repro_torch.launch import flops as F
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.models import lm
from repro_torch.runtime import spmd
from repro_torch.runtime import sharding as sh

NAMES2 = ("data", "model")
NAMES3 = ("pod", "data", "model")
SHAPED_MESHES = {"1x1": (1, 1), "2x2": (2, 2), "1x8": (1, 8),
                 "2x4": (2, 4), "2x2x2": (2, 2, 2), "16x16": (16, 16),
                 "2x16x16": (2, 16, 16)}


def _duck(shape):
    names = NAMES3 if len(shape) == 3 else NAMES2
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _jax_layout(node, group: bool):
    """A JAX Param tree's leaves as ``(axes, shape)``, the scanned groups'
    leading "layers" axis (and dim) dropped."""
    if is_param(node):
        axes, shape = tuple(node.axes), tuple(node.value.shape)
        if group:
            assert axes[0] == "layers"
            axes, shape = axes[1:], shape[1:]
        return axes, shape
    if isinstance(node, dict):
        return {k: _jax_layout(v, group) for k, v in node.items()}
    return [_jax_layout(v, group) for v in node]


def _jax_params(cfg) -> dict:
    """The JAX tree in the port's layout (``convert.params_from_jax``):
    ``{(axes, shape)}`` leaves."""
    tree = jax.eval_shape(lambda: jlm.init_model(jax.random.key(0), cfg))
    stack = tree["stack"]
    layers = [_jax_layout(b, False) for b in stack["head"]]
    groups = {k: _jax_layout(v, True) for k, v in stack["groups"].items()}
    for _ in range(cfg.n_groups):
        for i in range(len(cfg.pattern)):
            layers.append(groups[f"b{i}"])
    layers += [_jax_layout(b, False) for b in stack["tail"]]
    out = {"layers": layers,
           "final_norm": _jax_layout(tree["final_norm"], False)}
    for k in ("embed", "unembed", "heads"):
        if k in tree:
            out[k] = _jax_layout(tree[k], False)
    return out


def _pairs(port_axes, jax_tree, path=""):
    """``(path, port axes, (jax axes, shape))`` leaf by leaf; raises when
    the two trees' structures differ."""
    if isinstance(port_axes, dict):
        assert set(port_axes) == set(jax_tree), path
        for k in port_axes:
            yield from _pairs(port_axes[k], jax_tree[k], f"{path}/{k}")
    elif isinstance(port_axes, list):
        assert len(port_axes) == len(jax_tree), path
        for i, (a, b) in enumerate(zip(port_axes, jax_tree)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, port_axes, jax_tree


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_param_axes_equal_the_jax_params(arch):
    pairs = list(_pairs(lm.param_axes(SMOKES[arch]),
                        _jax_params(JSMOKES[arch])))
    assert pairs
    for path, ours, (theirs, _) in pairs:
        assert ours == theirs, path


def test_param_axes_cover_the_port_tree_and_its_moments():
    cfg = SMOKES["phi3.5-moe-42b-a6.6b"]
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    axes = lm.param_axes(cfg)
    shard = sh.param_shardings(_duck((2, 4)), params, axes)
    from repro_torch.optim import AdamW
    opt = AdamW(compress=True).init(params)
    oshard = sh.opt_state_shardings(_duck((2, 4)), params, opt, axes)
    for tree in (oshard.m, oshard.v, oshard.err):
        assert ([s.spec for s in _leaves(tree)]
                == [s.spec for s in _leaves(shard)])
    assert len(_leaves(shard)) == len(_leaves(params))


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_for_equals_jax_on_every_mesh(arch):
    pairs = list(_pairs(lm.param_axes(ARCHS[arch]),
                        _jax_params(JARCHS[arch])))
    for mesh_name, shape in SHAPED_MESHES.items():
        mesh = _duck(shape)
        for ours_rules, theirs_rules in (
                (sh.LOGICAL_RULES, jsh.LOGICAL_RULES),
                (sh.LOGICAL_RULES_SERVE, jsh.LOGICAL_RULES_SERVE)):
            for path, axes, (_, dims) in pairs:
                want = tuple(jsh.spec_for(axes, dims, mesh, theirs_rules))
                got = tuple(sh.spec_for(axes, dims, mesh, ours_rules))
                assert got == want, (mesh_name, path)


def test_rule_tables_equal_jax():
    assert sh.LOGICAL_RULES == jsh.LOGICAL_RULES
    assert sh.LOGICAL_RULES_SERVE == jsh.LOGICAL_RULES_SERVE
    for mesh in (None, object()):
        for kb in ("auto", "ref"):
            assert (sh.decode_compute_backend(mesh, kb)
                    == (kb if mesh is None else "ref"))


# ------------------------------------- the multidevice cases, fake meshes
MESH_NAMES = ["1dev", "2dev-data", "2dev-model", "8dev", "8dev-pod"]


def _device_mesh(*shape, names=NAMES2):
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


@pytest.fixture
def meshes():
    """Meshes over a fake-backend group of 8 ranks (this process rank 0),
    torn down after the test."""
    with fake_world(8):
        yield {"1dev": _device_mesh(1, 1), "2dev-data": _device_mesh(2, 1),
               "2dev-model": _device_mesh(1, 2), "8dev": _device_mesh(2, 4),
               "8dev-pod": _device_mesh(2, 2, 2, names=NAMES3)}


def _axes_of(entry):
    return (list(entry) if isinstance(entry, tuple)
            else [entry] if entry else [])


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("rules_name", ["LOGICAL_RULES",
                                        "LOGICAL_RULES_SERVE"])
def test_every_rule_resolves_on_every_mesh(meshes, mesh_name, rules_name):
    mesh = meshes[mesh_name]
    rules = getattr(sh, rules_name)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for logical, preferred in rules.items():
        want = [a for a in preferred if a in sizes]
        spec = sh.spec_for((logical,), (240,), mesh, rules)
        assert _axes_of(spec[0]) == want, (logical, mesh_name, spec)
        spec_prime = sh.spec_for((logical,), (241,), mesh, rules)
        assert all(sizes[a] == 1 for a in _axes_of(spec_prime[0]))


def test_serve_rules_disable_fsdp_only(meshes):
    assert sh.LOGICAL_RULES_SERVE["embed"] == ()
    mesh = meshes["8dev-pod"]
    assert sh.spec_for(("embed",), (64,), mesh) == sh.P(("pod", "data"))
    assert sh.spec_for(("embed",), (64,), mesh,
                       sh.LOGICAL_RULES_SERVE) == sh.P(None)


def test_greedy_prefix_respects_divisibility(meshes):
    mesh = meshes["8dev-pod"]
    assert sh.spec_for(("embed",), (6,), mesh) == sh.P("pod")
    assert sh.spec_for(("embed",), (4,), mesh) == sh.P(("pod", "data"))
    assert sh.spec_for(("embed",), (7,), mesh) == sh.P(None)


def test_param_shardings_follow_serve_rules(meshes):
    from torch.distributed.tensor import Replicate, Shard
    cfg = SMOKES["qwen1.5-0.5b"]
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    mesh = meshes["8dev"]
    train = sh.param_shardings(mesh, params, lm.param_axes(cfg))
    serve = sh.param_shardings(mesh, params, lm.param_axes(cfg),
                               serve=True)
    assert train["embed"].spec == sh.P("model", "data")
    assert serve["embed"].spec == sh.P("model", None)
    # placements: a tensor dim on a mesh axis is Shard(dim) there
    assert train["embed"].placements == [Shard(1), Shard(0)]
    assert serve["embed"].placements == [Replicate(), Shard(0)]
    for s in _leaves(serve):
        used = [a for e in s.spec for a in _axes_of(e)]
        assert "data" not in used and "pod" not in used


def test_composed_axes_shard_major_to_minor():
    """("pod", "data") on one dim is Shard(dim) on both mesh dims, and
    rank (p, d, m) holds the block JAX gives device p * data + d."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    for rank in range(8):
        with fake_world(8, rank=rank):
            mesh = _device_mesh(2, 2, 2, names=NAMES3)
            ns = sh.NamedSharding(mesh, sh.P(("pod", "data"), None))
            assert ns.placements == [Shard(0), Shard(0), Replicate()]
            p, d, _ = mesh.get_coordinate()
            _, off = compute_local_shape_and_global_offset(
                (8, 3), mesh, ns.placements)
            assert off[0] == (p * 2 + d) * 2
            fake = types.SimpleNamespace(device_mesh=mesh, shape=(8, 3),
                                         placements=ns.placements)
            assert spmd._owned_range(fake, 0) == (off[0], off[0] + 2)


@pytest.mark.parametrize("shape,mesh_shape,placements,to", [
    ((8, 1, 64), (2, 4), (0, 2), (8, 1, 4, 16)),      # a split, even
    ((8, 1, 64), (2, 8), (0, 2), (8, 1, 4, 16)),      # a split, uneven
    ((8, 1, 4, 16), (2, 4), (0, 2), (8, 1, 64)),      # a merge, outer dim
    ((8, 1, 4, 16), (2, 4), (0, 3), (8, 1, 64)),      # a merge, inner dim
    ((8, 16, 4, 16), (2, 4), (1, 2), (8, 16, 4, 1, 16)),
    ((8, 16, 4, 16), (2, 4), (1, 2), (8, 16, 2, 2, 16)),  # uneven split
])
def test_reshape_gathers_exactly_where_the_sharding_cannot_be_kept(
        shape, mesh_shape, placements, to):
    """``spmd._keeps_sharding`` says yes exactly where DTensor's own
    reshape keeps every shard a plain ``Shard`` (an uneven split raises,
    a merge of a sharded inner dim leaves a strided shard or a gathered
    one). ``spmd.reshape``
    then keeps each rank's block of the plain reshape, or gathers every
    dim but the batch dim first (the fake backend moves no values, so
    only the layout of a gathered one is checked)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    with fake_world(int(np.prod(mesh_shape))):
        mesh = _device_mesh(*mesh_shape)
        t = distribute_tensor(x, mesh, [Shard(d) for d in placements],
                              src_data_rank=None)
        try:
            out = t.reshape(to)
            kept = all(type(q) is Shard for p, q in
                       zip(t.placements, out.placements)
                       if isinstance(p, Shard))
        except RuntimeError:
            kept = False
        assert spmd._keeps_sharding(t, to) == kept
        got = spmd.reshape(t, *to)
        assert got.shape == x.reshape(to).shape
        if kept:
            local = x.reshape(to)[tuple(
                slice(lo, hi) for lo, hi in
                (spmd._owned_range(got, d) for d in range(got.ndim)))]
            assert torch.equal(got.to_local(), local)
        else:
            assert all(not isinstance(p, Shard) or p.dim == 0
                       for p in got.placements)


def test_cache_shardings_slot_axis_and_features(meshes, monkeypatch):
    cfg = SMOKES["qwen1.5-0.5b"].with_(compute_dtype="float32")
    states = lm.make_decode_state(cfg, 4, 32, torch.float32, "cpu")
    shardings = sh.cache_shardings(meshes["2dev-data"], states)
    for leaf, ns in zip(_flat(states), _flat(shardings)):
        spec = list(ns.spec) + [None] * (leaf.ndim - len(ns.spec))
        assert spec[0] == "data"              # slot axis (4 % 2 == 0)
        if leaf.ndim >= 3:
            assert spec[1] is None            # cache sequence axis
    # the JAX layout of the same states: each port layer's leaves are
    # laid out as JAX's [G, B, ...] group leaves, the scan axis dropped
    jcfg = JSMOKES["qwen1.5-0.5b"].with_(compute_dtype="float32")
    jstates = jax.eval_shape(lambda: jlm.make_decode_state(
        jcfg, 4, 32, dtype=np.float32))
    # the JAX builder wraps each spec in a NamedSharding, which wants a
    # mesh of real devices: keep the spec alone
    monkeypatch.setattr(jsh, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))
    for shape in ((2, 1), (1, 2), (2, 4), (2, 2, 2)):
        jspec = jsh.cache_shardings(_duck(shape), jstates)
        want = [tuple(s.spec)[1:] for s in jax.tree.leaves(jspec["groups"])]
        for layer in sh.cache_shardings(_duck(shape), states):
            assert [tuple(s.spec) for s in _flat(layer)] == want, shape


def _flat(t):
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _flat(v)]
    return [t]


def test_cache_shardings_divisibility_fallback(meshes):
    cfg = SMOKES["qwen1.5-0.5b"].with_(compute_dtype="float32")
    # 3 slots over data=2: the slot axis replicates
    states = lm.make_decode_state(cfg, 3, 32, torch.float32, "cpu")
    for mesh, batch_axis in ((meshes["2dev-data"], None),
                             (meshes["8dev"], None)):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        for leaf, ns in zip(_flat(states),
                            _flat(sh.cache_shardings(mesh, states))):
            spec = list(ns.spec) + [None] * (leaf.ndim - len(ns.spec))
            assert spec[0] == batch_axis
            for ax, dim in zip(spec, leaf.shape):
                if ax is not None:
                    total = int(np.prod([sizes[a] for a in _axes_of(ax)]))
                    assert dim % total == 0


def test_make_host_mesh_keeps_the_jax_fallback_rules():
    with fake_world(8):
        def shape(**kw):
            m = make_host_mesh(device="cpu", **kw)
            return dict(zip(m.mesh_dim_names, m.shape))
        assert shape(model=3) == {"data": 2, "model": 3}
        assert shape(data=2, model=2) == {"data": 2, "model": 2}
        assert shape(model=8) == {"data": 1, "model": 8}
        assert shape(model=16) == {"data": 1, "model": 8}
        with pytest.raises(ValueError, match="needs 16 devices; host has 8"):
            make_host_mesh(data=4, model=4, device="cpu")


def test_make_constrain_passes_plain_and_non_3d_tensors():
    constrain = sh.make_constrain(_duck((2, 2)))
    for t in (torch.zeros(4, 6, 8), torch.zeros(4, 8)):
        assert constrain(t) is t


_LOGICAL = [None, *sh.LOGICAL_RULES.keys()]
_DIMS = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 64, 240, 241]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(_LOGICAL),
                          st.sampled_from(_DIMS)),
                min_size=1, max_size=5),
       st.sampled_from(list(SHAPED_MESHES)),
       st.booleans())
def test_spec_never_reuses_axis_and_always_divides(dims, mesh_name, serve):
    mesh = _duck(SHAPED_MESHES[mesh_name])
    rules = sh.LOGICAL_RULES_SERVE if serve else sh.LOGICAL_RULES
    axes = tuple(a for a, _ in dims)
    shape = tuple(d for _, d in dims)
    spec = sh.spec_for(axes, shape, mesh, rules)
    assert tuple(spec) == tuple(jsh.spec_for(
        axes, shape, mesh,
        jsh.LOGICAL_RULES_SERVE if serve else jsh.LOGICAL_RULES))
    used = [a for e in spec for a in _axes_of(e)]
    assert len(used) == len(set(used))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for entry, dim in zip(spec, shape):
        if entry is not None:
            assert dim % int(np.prod([sizes[a] for a in _axes_of(entry)])) \
                == 0


# ------------------------------------------------ shapes and the FLOP model
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_jax(arch):
    for name, shape in SHAPES.items():
        assert SHAPES[name] == shape and name in JSHAPES
        ours = input_specs(ARCHS[arch], shape)
        theirs = jinput_specs(JARCHS[arch], JSHAPES[name])
        assert set(ours) == set(theirs)
        for k, t in ours.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(theirs[k].shape), (name, k)
            assert str(t.dtype).removeprefix("torch.") == \
                str(theirs[k].dtype), (name, k)
    from repro.configs import applicable as japplicable
    from repro_torch.configs import applicable
    for name in SHAPES:
        assert applicable(ARCHS[arch], SHAPES[name]) == \
            japplicable(JARCHS[arch], JSHAPES[name])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_flop_model_equals_jax(arch):
    assert F.param_counts(ARCHS[arch]) == JF.param_counts(JARCHS[arch])
    for shape in SHAPES.values():
        for seq, batch in ((shape.seq_len, shape.global_batch), (512, 3)):
            assert F.model_flops(ARCHS[arch], seq, batch, shape.kind) == \
                JF.model_flops(JARCHS[arch], seq, batch, shape.kind)
