"""DTensor-aware helpers the models call where a step may run on a mesh.

On a mesh (:mod:`repro_torch.runtime.sharding`) the weights, the decode
states and the step inputs are ``torch.distributed.tensor.DTensor`` s,
and most ops propagate their shardings by DTensor's own rules -- the
counterpart of GSPMD's propagation in the JAX package. What needs help
comes here, and each site names the layout it needs; no op is retried:

* **the products** (:func:`matmul` for the projections, :func:`einsum`
  for the attention and MoE contractions): the mesh product policy of
  the port, in one place (see each);
* **in-place index writes into a distributed state** (the KV cache
  writes of a decode step, the page scatters, the admission copy into a
  slot row): :func:`index_write` writes each rank's own rows of its
  local shard, with the values laid out as the state's trailing dims;
* **layouts an op has no sharding rule for**: :func:`unshard_dims`
  redistributes the dims that need it to ``Replicate()`` just before the
  op, as GSPMD inserts an all-gather (an uneven :func:`reshape`, a
  padded dim, the gathered pages). Each call that moves data is counted
  in :data:`COUNTS` (``"replicate"``), so a run can log how often it
  happened.

Every helper is the plain op on plain tensors: without a mesh nothing
changes, bit for bit.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

#: redistributions made by :func:`unshard_dims` / :func:`gather_fsdp` /
#: :func:`reshape` (an operand actually moved), index writes into a
#: distributed state (:func:`index_write`) and products run on local
#: operands (:func:`local_einsum`, and products whose operands every
#: rank holds whole)
COUNTS = {"replicate": 0, "index_write": 0, "local": 0}


def on_mesh(mesh):
    """The context a step on ``mesh`` runs in: plain tensors (masks,
    positions, host-made indices) meet DTensors as replicated ones. No
    mesh, no context."""
    if mesh is None:
        return contextlib.nullcontext()
    return implicit_replication()


def _is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def is_dist(t) -> bool:
    return isinstance(t, DTensor)


def local(t):
    """The full value of ``t`` as a plain tensor (gathered if sharded)."""
    return t.full_tensor() if is_dist(t) else t


def _owned_range(dst, dim: int):
    """``(lo, hi)`` of ``dst``'s dim ``dim`` held by this rank: the mesh
    dims that shard it split it in mesh order, major to minor (JAX's
    layout of a dim over composed axes)."""
    mesh = dst.device_mesh
    n = dst.shape[dim]
    lo, span = 0, n
    coords = mesh.get_coordinate()
    for md, p in enumerate(dst.placements):
        if isinstance(p, Shard) and p.dim == dim:
            k = mesh.size(md)
            if span % k:
                raise ValueError(f"dim {dim} of {tuple(dst.shape)} does not "
                                 f"divide over mesh dim {md} ({k})")
            span //= k
            lo += coords[md] * span
    return lo, lo + span


def index_write(dst, idx: tuple, src) -> None:
    """``dst[idx] = src`` in place, ``idx`` integer index tensors over
    ``dst``'s leading ``len(idx)`` dims (broadcast together), ``src``
    shaped ``idx`` + ``dst.shape[len(idx):]``. On a DTensor ``dst`` each
    rank writes the entries whose indices fall in its own shard of the
    indexed dims, at their local offsets; ``src`` is first laid out as
    ``dst``'s trailing dims are (sharded where they are, else
    replicated), so the write moves no state."""
    if not is_dist(dst):
        dst[idx] = local(src).to(dst.dtype) if is_dist(src) else \
            src.to(dst.dtype)
        return
    COUNTS["index_write"] += 1
    mesh = dst.device_mesh
    nidx = len(idx)
    idx = torch.broadcast_tensors(*(local(i).long() for i in idx))
    ish = idx[0].ndim
    want = []
    for p in dst.placements:
        if isinstance(p, Shard) and p.dim >= nidx:
            want.append(Shard(p.dim - nidx + ish))
        else:
            want.append(Replicate())
    if is_dist(src):
        src = src.redistribute(mesh, want).to_local()
    else:
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False).redistribute(
                                     mesh, want).to_local()
    loc = dst.to_local()
    keep = None
    offs = []
    for d, i in enumerate(idx):
        lo, hi = _owned_range(dst, d)
        if (lo, hi) != (0, dst.shape[d]):
            m = (i >= lo) & (i < hi)
            keep = m if keep is None else keep & m
        offs.append(i - lo)
    src = src.to(loc.dtype)
    if keep is None:
        loc[tuple(offs)] = src
    elif _is_fake(loc):
        # a dry-run (fake tensors) has no values, and a data-dependent
        # mask has no shape: write every entry, clamped into the shard
        loc[tuple(o.clamp(0, n - 1) for o, n in zip(offs, loc.shape))] = src
    else:
        loc[tuple(o[keep] for o in offs)] = src[keep]


def copy_into(dst, src) -> None:
    """``dst.copy_(src)`` in place; on a DTensor ``dst``, ``src`` is first
    laid out as ``dst`` is, then each rank copies its own shard."""
    if not is_dist(dst):
        dst.copy_(local(src))
        return
    mesh = dst.device_mesh
    if not is_dist(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    dst.to_local().copy_(src.redistribute(mesh, dst.placements).to_local())


def unshard_dims(t, dims: tuple):
    """``t`` with the mesh dims that shard any of ``dims`` made
    ``Replicate()`` (the rest of its layout kept): what a gather along
    ``dims`` needs. A plain tensor passes as it is."""
    if not is_dist(t):
        return t
    want = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
            for p in t.placements]
    if want == list(t.placements):
        return t
    COUNTS["replicate"] += 1
    return t.redistribute(t.device_mesh, want)


def _unshard_all_but_batch(t):
    return unshard_dims(t, tuple(range(1, t.ndim))) if is_dist(t) else t


def _whole(t) -> bool:
    """Whether every rank holds all of ``t`` (each mesh dim replicates it
    or has one rank)."""
    mesh = t.device_mesh
    return all(isinstance(p, Replicate) or mesh.size(i) == 1
               for i, p in enumerate(t.placements))


def _apply(fn, *args):
    """``fn(*args)`` with at least one DTensor operand: where every
    DTensor operand is whole on every rank (a 1x1 mesh, replicated
    operands), ``fn`` runs on the local tensors (nothing to communicate;
    DTensor's per-op dispatch is skipped) and the result is a replicated
    DTensor; otherwise DTensor's own sharding rules run it."""
    dist = [a for a in args if is_dist(a)]
    mesh = dist[0].device_mesh
    if not all(_whole(a) and a.device_mesh == mesh for a in dist):
        return fn(*args)
    COUNTS["local"] += 1
    out = fn(*(_local_contiguous_grad(a) if is_dist(a) else a
               for a in args))
    return DTensor.from_local(out.contiguous(), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def matmul(fn, x, w):
    """``fn(x, w)``, a projection ``x [..., K] @ w [K, N]`` with a DTensor
    operand: a sequence-parallel stream is gathered along its middle
    dims first (GSPMD's SP -> TP all-gather; a flattened batch-and-
    sequence shard has no mm sharding) and so is its gradient on the way
    back, and the weight's FSDP shards are gathered (ZeRO-3,
    :func:`gather_fsdp`). The products DTensor then runs are the
    column-parallel (output dim sharded: exact) and row-parallel
    (contraction sharded: a partial sum) ones of the TP layout."""
    mid = tuple(range(1, x.ndim - 1))
    out = _apply(fn, unshard_dims(x, mid), gather_fsdp(w))
    return unshard_grad(out, mid)


def einsum(spec: str, x, y):
    """``torch.einsum(spec, x, y)`` with a DTensor operand: on each rank's
    shards where that is exact (:func:`local_einsum`), else by DTensor's
    rules, the gradient of the result gathered along every dim but the
    batch dim (a sharded gradient meeting a flattened product has no mm
    sharding)."""
    out = local_einsum(spec, x, y)
    if out is not None:                  # its backward runs locally too
        return out
    out = _apply(lambda a, b: torch.einsum(spec, a, b), x, y)
    return unshard_grad(out, tuple(range(1, out.ndim)))


def _keeps_sharding(t, shape) -> bool:
    """Whether ``t.reshape(shape)`` keeps ``t``'s sharding as plain
    ``Shard`` placements. The reshape is read as runs of input dims that
    become runs of output dims (a split, a merge, or a dim kept); it
    keeps the sharding where each run is sharded on its first dim at
    most, evenly, and the first output dim of a sharded run divides by
    its shard count (an uneven split has no sharding; a merge whose inner
    dim is sharded leaves a strided one, which later products cannot
    propagate)."""
    count: dict[int, int] = {}
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard):
            if type(p) is not Shard:
                return False                    # already strided
            count[p.dim] = count.get(p.dim, 1) * t.device_mesh.size(m)
    ins, outs = list(t.shape), list(shape)
    if 0 in ins:
        return True
    i = j = 0
    while i < len(ins):
        i0, j0 = i, j
        a, b = ins[i], (outs[j] if j < len(outs) else 1)
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a, i = a * ins[i], i + 1
            else:
                b, j = b * outs[j], j + 1
        sharded = [d for d in range(i0, i) if d in count]
        if not sharded:
            continue
        k = count[i0] if sharded == [i0] else 0
        if (not k or ins[i0] % k or outs[j0] % k
                or (i - i0 > 1 and j - j0 > 1)):
            return False
    return True


def reshape(t, *shape):
    """``t.reshape(*shape)``; on a DTensor whose sharding the reshape
    cannot keep (:func:`_keeps_sharding`), ``t`` is first gathered along
    every dim but the batch dim."""
    if is_dist(t) and not _keeps_sharding(t, shape):
        t = _unshard_all_but_batch(t)
    return t.reshape(*shape)


class _UnshardGrad(torch.autograd.Function):
    """Identity forward; backward gathers the gradient along ``dims``."""

    @staticmethod
    def forward(ctx, t, dims):
        ctx.dims = dims
        return t

    @staticmethod
    def backward(ctx, g):
        return unshard_dims(g, ctx.dims), None


def unshard_grad(t, dims: tuple):
    """``t``, whose gradient is gathered along ``dims`` on the way back
    (a sequence-sharded gradient meeting a flattened product has no mm
    sharding); a plain tensor, or one that needs no gradient, as it is."""
    if not is_dist(t) or not t.requires_grad:
        return t
    return _UnshardGrad.apply(t, dims)


def _shard_letters(t, letters: str) -> list | None:
    """Per mesh dim, the einsum letter of ``t``'s dim sharded there (None
    where replicated); None when a placement is neither (a partial sum or
    a strided shard)."""
    out = []
    for p in t.placements:
        if isinstance(p, Replicate):
            out.append(None)
        elif type(p) is Shard:
            out.append(letters[p.dim])
        else:
            return None
    return out


def local_einsum(spec: str, x, y):
    """``torch.einsum(spec, x, y)`` on each rank's shards, with no
    communication, where that is exact: on every mesh dim the two
    operands are sharded on the same letter that the output keeps (a
    batch dim of the product), or one is sharded on a letter only it and
    the output carry while the other is replicated. The result is a
    DTensor sharded on those letters, bitwise the global product's
    elements. None where the layout does not allow it (DTensor's own
    rules take the product then)."""
    if not (is_dist(x) and is_dist(y)) or x.device_mesh != y.device_mesh:
        return None
    ins, out = spec.replace(" ", "").split("->")
    a, b = ins.split(",")
    if "." in spec or len(a) != x.ndim or len(b) != y.ndim:
        return None
    la, lb = _shard_letters(x, a), _shard_letters(y, b)
    if la is None or lb is None:
        return None
    mesh = x.device_mesh
    placements = []
    for m, (ca, cb) in enumerate(zip(la, lb)):
        c = ca or cb
        if c is None:
            placements.append(Replicate())
            continue
        if c not in out or (ca and cb and ca != cb):
            return None
        if not (ca and cb) and (c in a) == (c in b):
            return None          # one operand replicated on a shared letter
        n = (x.shape[a.index(c)] if ca else y.shape[b.index(c)])
        if n % mesh.size(m):
            return None
        placements.append(Shard(out.index(c)))
    COUNTS["local"] += 1
    # every sharded dim divides evenly: the global shape and strides follow
    # from the local result's (made contiguous: a permuted local layout
    # under a sharded dim gives global strides later views cannot use)
    def grads(t, letters):
        # an operand replicated where the product is sharded on a letter
        # it lacks sees only that shard's share of its gradient
        return [Partial() if isinstance(p, Replicate) and type(q) is Shard
                and out[q.dim] not in letters else p
                for p, q in zip(t.placements, placements)]

    res = torch.einsum(spec, _local_contiguous_grad(x, grads(x, a)),
                       _local_contiguous_grad(y, grads(y, b))).contiguous()
    return DTensor.from_local(res, mesh, placements, run_check=False)


def _local_contiguous_grad(t, grad_placements=None):
    """``t.to_local()``, whose gradient is made contiguous on the way back
    (the DTensor it becomes carries ``t``'s contiguous global strides);
    ``grad_placements`` the gradient's layout where it is not ``t``'s (a
    partial sum where each rank saw only its shard of the other
    operand)."""
    loc = t.to_local(grad_placements=grad_placements)
    if loc.requires_grad:
        loc.register_hook(lambda g: g.contiguous())
    return loc


def gather_fsdp(w):
    """A weight DTensor with its shards over the data axes ("pod",
    "data") gathered and its tensor-parallel ("model") layout kept: the
    ZeRO-3 all-gather before a product whose activations are sharded over
    the same axes by batch (left to itself, DTensor may split the
    contraction instead and all-reduce batch-replicated outputs). A plain
    tensor passes as it is."""
    if not is_dist(w):
        return w
    names = w.device_mesh.mesh_dim_names or ()
    want = [Replicate() if names[m] in ("pod", "data") else p
            for m, p in enumerate(w.placements)]
    if want == list(w.placements):
        return w
    COUNTS["replicate"] += 1
    return w.redistribute(w.device_mesh, want)


def pad(t, widths: tuple):
    """``torch.nn.functional.pad(t, widths)``; on a DTensor the padded
    dims are gathered if sharded and each rank pads its own shard (the
    layout kept), which every torch version's DTensor does the same."""
    if not is_dist(t):
        return torch.nn.functional.pad(t, widths)
    dims = tuple(t.ndim - 1 - i // 2 for i in range(len(widths))
                 if widths[i])
    t = unshard_dims(t, dims)
    return DTensor.from_local(
        torch.nn.functional.pad(_local_contiguous_grad(t), widths),
        t.device_mesh, t.placements, run_check=False)


def embedding(table, ids):
    """``table[ids]`` for a DTensor ``table`` ``[V, D]``: on whole operands
    the local lookup; for a table sharded by vocabulary (its FSDP shards
    over the data axes gathered first) each rank looks up the ids it holds
    rows for, zeros the rest, and the result is a partial sum over the
    vocabulary's mesh dims -- exactly one rank adds each row, so the sum
    is the row, bitwise. Its backward is local too (DTensor's own
    accumulating index backward has no sharding for batch-sharded ids in
    some torch versions)."""
    if all(_whole(t) for t in (table, ids) if is_dist(t)):
        return _apply(lambda e, i: e[i], table, ids)
    table = gather_fsdp(table)
    mesh = table.device_mesh
    if any(not isinstance(p, Replicate) and not (type(p) is Shard
                                                 and p.dim == 0)
           for p in table.placements):
        return table[ids]
    if not is_dist(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    vocab = [m for m, p in enumerate(table.placements)
             if isinstance(p, Shard)]
    want = [Replicate() if m in vocab else p
            for m, p in enumerate(ids.placements)]
    if want != list(ids.placements):
        ids = ids.redistribute(mesh, want)
    lo, hi = _owned_range(table, 0)
    loc = ids.to_local()
    keep = (loc >= lo) & (loc < hi)
    # the table's gradient: a partial sum where the ids are sharded (each
    # rank saw its own batch)
    grad = [Partial() if isinstance(q, Shard) else p
            for p, q in zip(table.placements, ids.placements)]
    rows = _local_contiguous_grad(table, grad)[
        (loc - lo).clamp(0, hi - lo - 1)]
    rows = rows * keep[..., None].to(rows.dtype)
    placements = [Partial() if m in vocab else p
                  for m, p in enumerate(ids.placements)]
    return DTensor.from_local(rows, mesh, placements, run_check=False)
