"""Per-rank op-level analysis of one step on a mesh: the port's
counterpart of the JAX package's ``repro.launch.hlo_analysis``.

The JAX package reads the compiled, partitioned HLO text; the port has no
compiled graph, so it counts the ops one step dispatches. :func:`analyze`
runs a function under a ``TorchDispatchMode`` of its own (usually inside
``FakeTensorMode`` over a fake process group: no card, no memory, no
communication) and counts, **per rank**:

* ``dot_flops`` -- the FLOPs of every matmul-like op (``mm``, ``addmm``,
  ``bmm``, convolutions, attention), by ``torch.utils.flop_counter``'s
  formulas;
* ``mem_bytes`` -- bytes read and written by each op that computes
  (inputs plus outputs; views, metadata and collectives excluded): the
  memory term;
* ``per_kind`` -- collective bytes by kind (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``), each the byte size
  of the collective's result, as the HLO analysis counts them;
* ``peak_bytes`` -- the peak live bytes: the arguments' local bytes plus
  the most that the ops' outputs held alive at once (views excluded).

**Per rank, from the local op.** A DTensor op is seen twice by a dispatch
mode: once on the global DTensors, then -- after the mode returns
``NotImplemented`` and DTensor desugars it -- as the local ops on each
rank's shards and the collectives that redistribute them. The counts
here are taken from the local ops only; ``torch.utils.flop_counter.
FlopCounterMode`` counts the DTensor-level op, i.e. the GLOBAL FLOPs.

The port unrolls its layers and attention loops, so every iteration is
dispatched and counted: no loop-trip correction is needed. On a CPU mesh
(the dry-run's) DTensor lowers a shard-to-shard all-to-all as an
all-gather and a chunk, so those bytes are counted under ``all-gather``,
as that program moves them.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.runtime.spmd import is_dist

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


def _kinds() -> dict:
    fn = torch.ops._c10d_functional
    c10d = torch.ops.c10d
    table = {
        fn.all_reduce: "all-reduce", fn.all_reduce_: "all-reduce",
        fn.all_gather_into_tensor: "all-gather",
        fn.reduce_scatter_tensor: "reduce-scatter",
        fn.all_to_all_single: "all-to-all",
        c10d.allreduce_: "all-reduce", c10d.allgather_: "all-gather",
        c10d._allgather_base_: "all-gather",
        c10d._reduce_scatter_base_: "reduce-scatter",
        c10d.reduce_scatter_: "reduce-scatter",
        c10d.alltoall_base_: "all-to-all", c10d.alltoall_: "all-to-all",
    }
    return {op: k for op, k in table.items()}


#: ops with no HBM traffic of their own (layout, metadata, waits)
_FREE = {"wait_tensor", "detach", "view", "_unsafe_view", "alias",
         "t", "transpose", "permute", "expand", "slice", "select",
         "unsqueeze", "squeeze", "as_strided", "split", "split_with_sizes",
         "unbind", "chunk", "narrow", "reshape", "_reshape_alias",
         "lift_fresh", "empty", "empty_like", "empty_strided", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "_local_scalar_dense", "unflatten", "flatten", "view_as_real"}


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _result_bytes(op, args, out) -> int:
    """Bytes of a collective's result."""
    if isinstance(out, torch.Tensor):
        return _bytes(out)
    name = op.__name__
    if name.startswith("allreduce"):
        return sum(_bytes(t) for t in args[0])
    # the c10d in-place forms write their first argument
    first = args[0]
    leaves, _ = tree_flatten(first)
    return sum(_bytes(t) for t in leaves)


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is running the op once on
    fake global tensors, to learn its output's shape (not the program's
    op)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


class _Counter(TorchDispatchMode):
    def __init__(self, fake_mode=None):
        super().__init__()
        # DTensor's sharding propagation runs each new op once on fake
        # global tensors of its own FakeTensorMode: not the program's op
        self.fake_mode = fake_mode
        self.flop_registry = flop_registry
        self.kinds = _kinds()
        self.dot_flops = 0
        self.mem_bytes = 0
        self.per_kind: dict[str, int] = defaultdict(int)
        self.ops = 0
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count the local ops it becomes
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if _in_propagation() or any(
                isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode
                for t in ins):
            return out
        packet = func._overloadpacket
        if packet in self.kinds:
            self.per_kind[self.kinds[packet]] += _result_bytes(packet, args,
                                                               out)
            self.ops += 1
            return out
        if packet in self.flop_registry:
            self.dot_flops += int(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        name = packet.__name__
        if name in _FREE or func.is_view:
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.mem_bytes += sum(map(_bytes, ins)) + sum(map(_bytes, outs))
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen:                  # in place: nothing new lives
                continue
            n = _bytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def local_bytes(tree) -> int:
    """This rank's bytes of every tensor leaf of ``tree`` (a DTensor's
    local shard)."""
    leaves, _ = tree_flatten(tree)
    return sum(_bytes(t.to_local() if is_dist(t) else t) for t in leaves
               if isinstance(t, torch.Tensor))


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its ops per rank (see
    the module doc). Returns ``{"dot_flops", "mem_bytes", "per_kind":
    {kind: bytes}, "total": collective bytes, "ops": collective count,
    "peak_bytes", "arg_bytes"}``."""
    arg_bytes = local_bytes((args, kwargs))
    leaves = [t.to_local() if is_dist(t) else t
              for t in tree_flatten((args, kwargs))[0]
              if isinstance(t, torch.Tensor)]
    counter = _Counter(detect_fake_mode(leaves))
    with counter:
        fn(*args, **kwargs)
    per_kind = {k: int(counter.per_kind.get(k, 0)) for k in COLLECTIVES}
    return {"dot_flops": int(counter.dot_flops),
            "mem_bytes": int(counter.mem_bytes),
            "per_kind": per_kind, "total": sum(per_kind.values()),
            "ops": counter.ops,
            "peak_bytes": int(arg_bytes + counter.peak),
            "arg_bytes": int(arg_bytes)}
