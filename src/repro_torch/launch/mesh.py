"""Mesh construction over ``torch.distributed`` ranks.

Defined as FUNCTIONS (never module-level constants): importing this
module starts no process group and touches no device.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, one rank a device, with dimension names
``("data", "model")`` (or ``("pod", "data", "model")``): "data" (and
"pod") carry batch/FSDP sharding, "model" TP/SP/EP
(:mod:`repro_torch.runtime.sharding`).

* :func:`make_host_mesh` -- a small ``data x model`` mesh (tests,
  examples, single-host serving and training). With no process group and
  a world of one process it starts one of its own: NCCL on the card, gloo
  on the CPU, over an in-process ``HashStore`` (no port, no network).
* :func:`make_production_mesh` -- the dry-run's meshes, one pod ``(data=16,
  model=16)`` = 256 ranks and two ``(pod=2, data=16, model=16)`` = 512,
  meant for the single-process ``"fake"`` backend
  (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device: str | None) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the mesh is built on the card by "
            "default; pass device='cpu' to build it over gloo on the CPU")
    return kind


def _ensure_process_group(device: str | None = "cuda") -> None:
    """Start a one-process default group if none exists (NCCL for the
    card, gloo for the CPU) on an in-process ``HashStore``. A world of
    several processes must start its own group first."""
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != 1:
        raise RuntimeError(
            f"WORLD_SIZE={world}: start the default process group "
            f"(torch.distributed.init_process_group) before building a mesh")
    kind = _device_type(device)
    if kind == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(model: int | None = None, data: int | None = None,
                   device: str | None = "cuda"):
    """A ``("data", "model")`` mesh over the default group's ranks.

    * ``model`` only: the requested TP width is HONORED (it decides
      memory and layout) and data is whatever is left (``world //
      model``) -- on 8 ranks ``model=3`` gives a 2x3 mesh over 6 ranks,
      idling two. Only an unsatisfiable request (``model > world``) falls
      back, to ``model = world``.
    * ``data`` and ``model``: exactly that shape, over the first ``data *
      model`` ranks.

    Ranks outside the mesh get it too (every rank must build it) and sit
    out: :func:`in_mesh` is false there, and they run no step on it."""
    _ensure_process_group(device)
    n = dist.get_world_size()
    model = max(model or 1, 1)
    if data is None:
        model = min(model, n)
        data = n // model
    if data < 1 or data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices; "
            f"host has {n}")
    kind = _device_type(device) if device is not None else (
        "cuda" if dist.get_backend() == "nccl" else "cpu")
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(kind, ranks, mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cpu"):
    """The dry-run's mesh: ``(data=16, model=16)``, or ``(pod=2, data=16,
    model=16)`` with ``multi_pod``, over a default group of 256 or 512
    ranks (the fake backend: :func:`fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def in_mesh(mesh) -> bool:
    """Whether this rank holds a coordinate of ``mesh``."""
    return mesh.get_coordinate() is not None


class fake_world:
    """Context manager: a single-process ``"fake"`` default group of
    ``size`` ranks (this process is ``rank``), destroyed on exit. Nothing
    is communicated: collectives return their inputs' shapes, which is
    what shape-level analysis (the dry-run) needs."""

    def __init__(self, size: int, rank: int = 0):
        self.size, self.rank = size, rank

    def __enter__(self):
        # importing it registers the backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        if dist.is_initialized():
            raise RuntimeError("a default process group already exists")
        dist.init_process_group("fake", store=FakeStore(), rank=self.rank,
                                world_size=self.size)
        return self

    def __exit__(self, *exc):
        dist.destroy_process_group()
        return False
