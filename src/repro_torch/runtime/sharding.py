"""Logical-axis -> mesh-axis sharding rules (t5x-style), on a
``torch.distributed.device_mesh.DeviceMesh``.

Parameters carry logical axis names (:func:`repro_torch.models.lm.
param_axes`); this module resolves them against a mesh whose dimensions
are named ``("data", "model")`` or ``("pod", "data", "model")``, as the
JAX package's ``repro.runtime.sharding`` does:

* FSDP: the "embed" logical axis shards over the composed data axes
  ("pod", "data") -- parameters AND optimizer state are ZeRO-3 sharded.
* TP:   "heads" / "ff" / "vocab" / "heads_ff" shard over "model".
* EP:   "expert" shards over "model" (experts live TP-wide).
* SP:   activations between blocks are constrained to
  P(dp_axes, "model", None) -- sequence-parallel residual stream.

Every rule application is guarded by divisibility: a dimension that does
not divide evenly over its assigned mesh axes falls back to replication,
and a mesh axis is never used twice in one spec.

Resolution (:func:`spec_for` and the ``*_shardings`` builders) reads only
the mesh's dimension names and sizes -- a ``DeviceMesh``, or anything
with ``axis_names`` and ``devices.shape`` as a JAX mesh has -- so the
rules run with no process group. A :class:`PartitionSpec` becomes DTensor
placements in :class:`NamedSharding`: a tensor dim on one mesh axis is
``Shard(d)`` on that mesh dim, a dim on the composed axes ``("pod",
"data")`` is ``Shard(d)`` on both, major to minor as JAX lays it out,
and every other mesh dim is ``Replicate()``. :func:`device_put`
distributes a tree by a tree of shardings (``distribute_tensor``), and
the constraint of :func:`make_constrain` redistributes (the JAX
``with_sharding_constraint``).
"""
from __future__ import annotations

import math
from typing import Any

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.optim import AdamWState
from repro_torch.runtime.spmd import is_dist, local
from repro_torch.tree import tree_map

#: logical axis -> preferred mesh axes (first-fit with divisibility checks)
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "embed": ("pod", "data"),      # FSDP
    "vocab": ("model",),
    "heads": ("model",),
    "ff": ("model",),
    "heads_ff": ("model",),
    "expert": ("model",),
    "kv_lora": ("model",),
    "layers": (),                  # scan axis: never sharded
}

#: Serving rules: weights are read every step and there is no optimizer
#: state, so FSDP-style gathering over the data axes is pure overhead --
#: replicate over data, shard only on the model (TP) axis.
LOGICAL_RULES_SERVE: dict[str, tuple[str, ...]] = {
    **LOGICAL_RULES,
    "embed": (),
}


def decode_compute_backend(mesh, kernel_backend: str) -> str:
    """The kernel backend a serve decode step runs on ``mesh``.

    A decode step over distributed tensors runs the ``"ref"`` model
    compute whatever ``ServeConfig.kernel_backend`` says (the hand-written
    decode kernels take whole local operands), as the JAX package's mesh
    decode does. The power accountant is NOT downgraded: it streams
    gathered local operands outside the step, so mesh + ``"auto"`` keeps
    the counter kernels and the bit-identity contract."""
    return kernel_backend if mesh is None else "ref"


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (the dim split over them, major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a JAX-like mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_names(mesh) -> tuple[str, ...]:
    return tuple(_mesh_axes(mesh))


def dp_axes(mesh) -> tuple[str, ...]:
    names = _axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _resolve_dim(logical: str | None, size: int, mesh, used: set[str],
                 rules: dict | None = None):
    """Mesh axes for one dimension, or None (replicate)."""
    rules = rules if rules is not None else LOGICAL_RULES
    if logical is None:
        return None
    sizes = _mesh_axes(mesh)
    want = [a for a in rules.get(logical, ()) if a in sizes and a not in used]
    if not want:
        return None
    # greedy prefix of the preferred axes whose product divides the dim
    chosen: list[str] = []
    prod = 1
    for a in want:
        if size % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    if not chosen:
        return None
    used.update(chosen)
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def spec_for(axes: tuple[str | None, ...], shape: tuple[int, ...], mesh,
             rules: dict | None = None) -> PartitionSpec:
    used: set[str] = set()
    return P(*[_resolve_dim(ax, dim, mesh, used, rules)
               for ax, dim in zip(axes, shape)])


def placements(mesh, spec: PartitionSpec) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    out = []
    for name in _axis_names(mesh):
        dim = None
        for d, entry in enumerate(spec):
            group = entry if isinstance(entry, tuple) else (entry,)
            if name in group:
                dim = d
        out.append(Shard(dim) if dim is not None else Replicate())
    return out


class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (:attr:`placements` needs a real ``DeviceMesh``)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"


# ------------------------------------------------------------ tree walks
def _is_tensor(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _map_axes(fn, tree, axes):
    """``fn(leaf, axes)`` over a parameter tree and its logical-axes tree
    (tuples of names are leaves there)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v, axes[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(fn, v, a) for v, a in zip(tree, axes)]
    return fn(tree, axes)


def param_shardings(mesh, params, axes, serve: bool = False) -> Any:
    """Tree of :class:`NamedSharding` matching a parameter tree, from its
    logical axes (:func:`repro_torch.models.lm.param_axes`, or
    ``weight_axes`` for the compute weights). ``serve=True`` uses the
    TP-only serving rules (no FSDP gathering)."""
    rules = LOGICAL_RULES_SERVE if serve else LOGICAL_RULES
    return _map_axes(lambda p, ax: NamedSharding(
        mesh, spec_for(ax, tuple(p.shape), mesh, rules)), params, axes)


def _dp(mesh):
    sizes = _mesh_axes(mesh)
    dpx = dp_axes(mesh)
    dp_size = math.prod(sizes[a] for a in dpx) if dpx else 1
    dp = dpx if len(dpx) > 1 else (dpx[0] if dpx else None)
    return dpx, dp_size, dp, sizes.get("model", 1)


def tree_shardings(mesh, tree) -> Any:
    """Greedy shardings for non-parameter trees (decode states, batches):
    batch dim -> data axes, then the largest remaining dim -> model."""
    dpx, dp_size, dp, model = _dp(mesh)

    def one(a):
        if not _is_tensor(a) or a.ndim == 0:
            return NamedSharding(mesh, P())
        spec: list = [None] * a.ndim
        # batch axis: the first dp-divisible dim of the leading two
        bdim = None
        for i in range(min(2, a.ndim)):
            if dpx and a.shape[i] % dp_size == 0 and a.shape[i] > 0:
                bdim = i
                spec[i] = dp
                break
        if model > 1:
            # prefer TRAILING dims (feature/head dims) for the model axis:
            # sharding a KV cache's sequence dim would gather it inside
            # decode attention
            for i in range(a.ndim - 1, 0, -1):
                if i == bdim:
                    continue
                if a.shape[i] % model == 0 and a.shape[i] >= model:
                    spec[i] = "model"
                    break
        return NamedSharding(mesh, P(*spec))

    return tree_map(one, tree)


def cache_shardings(mesh, states) -> Any:
    """Shardings for a serving slot cache (``lm.make_decode_state``).

    The port's states are a list of per-layer leaves ``[B, ...]`` (the JAX
    package's scanned ``[G, B, ...]`` groups unstacked), so the slot axis
    -- dim 0 -- shards over the data axes. One trailing feature dim (kv
    heads / head dim / lora rank) shards over "model", matching the TP
    layout the serve rules give the attention weights; the dim right after
    the slot axis is the cache sequence/window dim and is never given to
    "model" (sharding it would gather inside every decode step). Every
    assignment is divisibility-guarded: awkward slot counts or head counts
    fall back to replication."""
    dpx, dp_size, dp, model = _dp(mesh)

    def one(a):
        if not _is_tensor(a) or a.ndim == 0:
            return NamedSharding(mesh, P())
        spec: list = [None] * a.ndim
        if dpx and a.shape[0] % dp_size == 0:
            spec[0] = dp
        if model > 1:
            # trailing feature dims only; a leaf with a sequence dim
            # (ndim >= 3) has it at dim 1, excluded from the candidates
            lo = 2 if a.ndim >= 3 else 1
            for i in range(a.ndim - 1, lo - 1, -1):
                if a.shape[i] % model == 0 and a.shape[i] >= model:
                    spec[i] = "model"
                    break
        return NamedSharding(mesh, P(*spec))

    return tree_map(one, states)


def paged_cache_shardings(mesh, states) -> Any:
    """Shardings for a paged KV pool (``serve.paging.cache``): the pool is
    ``lm.make_decode_state`` with the PAGE axis in the slot axis's role
    (leaves ``[P, page_size, ...]``), so the slot-cache rules apply
    verbatim: pages over the data axes, one trailing feature dim over
    "model", the within-page sequence dim never sharded. Keeping the
    reserved trash page inside the pool (not ``num_pages - 1`` pages) is
    what keeps the page axis divisible."""
    return cache_shardings(mesh, states)


def batch_shardings(mesh, batch) -> Any:
    """Input batches: shard the batch dim over the data axes; leading-
    component leaves (M-RoPE positions [3, B, S]) shard dim 1."""
    dpx, dp_size, dp, _ = _dp(mesh)

    def one(a):
        if not _is_tensor(a) or a.ndim == 0 or not dpx:
            return NamedSharding(mesh, P())
        spec = [None] * a.ndim
        if a.shape[0] % dp_size == 0:
            spec[0] = dp
        elif a.ndim > 1 and a.shape[1] % dp_size == 0:
            spec[1] = dp
        return NamedSharding(mesh, P(*spec))

    return tree_map(one, batch)


def make_constrain(mesh):
    """Residual-stream constraint: batch over data axes + sequence-parallel
    over "model" (decode steps with S=1 skip the seq constraint). Plain
    tensors and tensors that are not 3-D pass as they are."""
    dpx, dp_size, dp, model = _dp(mesh)

    def constrain(x):
        if not is_dist(x) or x.ndim != 3:
            return x
        b, s, _ = x.shape
        bspec = dp if (dpx and b % dp_size == 0) else None
        sspec = "model" if (model > 1 and s % model == 0 and s > 1) else None
        want = placements(mesh, P(bspec, sspec, None))
        if list(x.placements) == want:
            return x
        return x.redistribute(mesh, want)

    return constrain


def opt_state_shardings(mesh, params, opt_state, axes):
    """AdamW state mirrors the param tree (``m``, ``v``, ``err``)."""
    ps = param_shardings(mesh, params, axes)

    def like(sub):
        return ps if sub is not None else None
    return AdamWState(m=like(opt_state.m), v=like(opt_state.v),
                      err=like(opt_state.err))


# ------------------------------------------------------------ placement
def device_put(tree, shardings):
    """Distribute every tensor leaf of ``tree`` by the
    :class:`NamedSharding` at its position in ``shardings`` (a DTensor
    leaf is redistributed): the JAX ``device_put``. Each rank of an SPMD
    run holds the same full value of a plain leaf (the same host state,
    the same seed), so each takes its own shard of it locally: nothing
    is sent."""
    def one(t, ns):
        if is_dist(t):
            return t.redistribute(ns.mesh, ns.placements)
        return distribute_tensor(t, ns.mesh, ns.placements,
                                 src_data_rank=None)

    return tree_map(one, tree, shardings)


def gather(tree):
    """Every DTensor leaf of ``tree`` as its full plain tensor."""
    return tree_map(local, tree)
