"""Fault-tolerant checkpoints of the port's trees (dicts, lists and
named tuples of tensors), in the JAX package's layout
(``repro.checkpoint.ckpt``):

* a step is written to ``step_XXXXXXXX.tmp`` and renamed into place, so
  a crash mid-write never corrupts the latest checkpoint;
* ``LATEST`` names the newest step; it is replaced atomically after the
  rename, so a restore never races a writer;
* each step holds ``shard_0000.npz`` (leaf ``i`` under ``leaf_i``, in
  :func:`repro_torch.tree.tree_leaves` order) and ``meta.json`` (the
  structure fingerprint: leaf count, shapes, dtypes; the step; the
  time), and a restore checks the structure before it reads a weight;
* an asynchronous save copies the leaves to the host at once and writes
  them on a background thread, which ``wait()`` (and the next save or
  restore) joins; old steps are removed down to ``keep``.

bfloat16 leaves, which numpy lacks, are stored as their uint16 bits and
restored from them by the dtype in ``meta.json``.

Distributed trees (DTensor leaves, a mesh run) are saved as full
tensors: every rank gathers each leaf, rank 0 writes, and the ranks meet
at a barrier before the next save or restore reads. A restore re-places
the arrays onto the target's layout, or onto ``shardings`` -- a tree of
:class:`repro_torch.runtime.sharding.NamedSharding` of another mesh (an
elastic restart), as the JAX package's ``restore(..., shardings)`` does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch.runtime import spmd
from repro_torch.tree import tree_leaves, tree_unflatten

LATEST = "LATEST"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _structure_fingerprint(tree) -> dict:
    leaves = tree_leaves(tree)
    return {
        "n_leaves": len(leaves),
        "shapes": [list(map(int, l.shape)) for l in leaves],
        "dtypes": [_dtype_name(l) for l in leaves],
    }


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = spmd.local(t).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def _place(leaf: torch.Tensor, target, sharding):
    """A restored leaf in ``target``'s dtype, on its device -- or
    distributed by ``sharding``, or as a DTensor ``target`` is."""
    if sharding is None and not spmd.is_dist(target):
        return leaf.to(device=target.device, dtype=target.dtype)
    mesh = sharding.mesh if sharding is not None else target.device_mesh
    pl = (sharding.placements if sharding is not None
          else target.placements)
    return distribute_tensor(
        leaf.to(device=mesh.device_type, dtype=target.dtype), mesh, pl)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._sync = False         # a distributed save awaits its barrier
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any) -> None:
        """Write ``tree`` as step ``step`` (on a background thread when
        asynchronous; its leaves are copied to the host before this
        returns, so the caller may change them at once)."""
        self.wait()
        leaves = tree_leaves(tree)
        host_leaves = [_to_host(l) for l in leaves]
        meta = _structure_fingerprint(tree)
        meta["step"] = int(step)
        meta["time"] = time.time()
        if any(spmd.is_dist(l) for l in leaves):
            self._sync = dist.get_world_size() > 1
            if dist.get_rank() != 0:
                return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(int(step), host_leaves, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(int(step), host_leaves, meta)

    def _write(self, step: int, leaves: list[np.ndarray], meta: dict):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "shard_0000.npz"),
                 **{f"leaf_{i}": l for i, l in enumerate(leaves)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        ptr_tmp = os.path.join(self.dir, LATEST + ".tmp")
        with open(ptr_tmp, "w") as f:
            f.write(name)
        os.replace(ptr_tmp, os.path.join(self.dir, LATEST))
        self._gc()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def wait(self):
        """Join the background write, if one is running (after a
        distributed save, then meet the other ranks)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sync:
            dist.barrier()
            self._sync = False

    # ---------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        ptr = os.path.join(self.dir, LATEST)
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, step: int, target: Any, shardings: Any = None) -> Any:
        """Step ``step`` as a tree shaped like ``target``, each leaf new,
        on its target leaf's device and in its dtype -- distributed as the
        target leaf is, or by ``shardings`` (a tree of ``NamedSharding``
        shaped like ``target``) when given; raises ``ValueError`` when the
        saved shapes are not the target's."""
        self.wait()
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        want = _structure_fingerprint(target)
        if meta["shapes"] != want["shapes"]:
            raise ValueError(
                f"checkpoint structure mismatch at step {step}: "
                f"{len(meta['shapes'])} leaves saved vs "
                f"{len(want['shapes'])} wanted")
        with np.load(os.path.join(path, "shard_0000.npz")) as data:
            leaves = [_from_host(data[f"leaf_{i}"], meta["dtypes"][i])
                      for i in range(meta["n_leaves"])]
        targets = tree_leaves(target)
        placed = (tree_leaves(shardings) if shardings is not None
                  else [None] * len(targets))
        return tree_unflatten(target, [
            _place(l, t, s) for l, t, s in zip(leaves, targets, placed)])

    def restore_latest(self, target: Any):
        """``(step, tree)`` of the latest step, or ``(None, None)``."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target)
