"""Dry-run: one step of every (arch x shape x mesh) cell on the production
meshes, with no card and no memory.

Each cell runs in one process under the single-process ``"fake"``
process group (256 ranks for the 16x16 mesh, 512 for 2x16x16; this
process is rank 0) and ``FakeTensorMode``: the parameters, optimizer
state, caches and batches are fake tensors distributed by the sharding
rules (:mod:`repro_torch.runtime.sharding`), and the step -- the train
step, the prefill or one decode step -- is dispatched op by op, so the
distribution is shown coherent (every op has a sharding, every
collective a shape) and :mod:`repro_torch.launch.graph_analysis` counts
per rank:

  * dot FLOPs, memory bytes and collective bytes by kind, and the peak
    live bytes (against the card's 80 GB);
  * beside :func:`repro_torch.launch.flops.model_flops`' analytic
    MODEL_FLOPS, and their ratio.

Results are cached as JSON per cell under ``results/dryrun_torch/`` (the
sweep resumes), and :mod:`repro_torch.launch.roofline` reads them:

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen1.5-0.5b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.roofline

This is the port's counterpart of the JAX package's
``repro.launch.dryrun``, which lowers and compiles each cell for the TPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.configs import input_specs
from repro_torch.launch import flops as F
from repro_torch.launch import graph_analysis as G
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.config import jax_form
from repro_torch.optim import AdamW
from repro_torch.runtime import sharding as sh
from repro_torch.runtime import spmd
from repro_torch.tree import tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def _fake(spec: torch.Tensor) -> torch.Tensor:
    """A zero tensor of ``spec``'s shape and dtype (under the fake mode)."""
    return torch.zeros(spec.shape, dtype=spec.dtype)


def build_cell(cfg, shape, mesh):
    """``(step, args)`` of one cell: the step function and its arguments,
    distributed on ``mesh`` (call under ``FakeTensorMode``)."""
    constrain = sh.make_constrain(mesh)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    batch = {k: _fake(v) for k, v in input_specs(cfg, shape).items()}
    batch = sh.device_put(batch, sh.batch_shardings(mesh, batch))

    if shape.kind == "train":
        opt = AdamW()
        opt_state = opt.init(params)
        axes = lm.param_axes(cfg)
        params = sh.device_put(params, sh.param_shardings(mesh, params,
                                                          axes))
        opt_state = sh.device_put(opt_state, sh.opt_state_shardings(
            mesh, params, opt_state, axes))
        step = lm.make_train_step(cfg, opt, constrain=constrain)
        return step, (params, opt_state, batch, 0)
    # inference holds bf16 weights (no optimizer/master copies), TP-only
    # (replicated over data): no per-step FSDP gathers
    serve = shape.kind == "decode"
    weights = lm.compute_weights(params, cfg)
    if serve:
        weights = tree_map(lambda t: t.to(torch.bfloat16)
                           if t.dtype == torch.float32 else t, weights)
    weights = sh.device_put(weights, sh.param_shardings(
        mesh, weights, lm.weight_axes(cfg), serve=serve))
    inputs, positions = lm.model_input(cfg, batch)
    if shape.kind == "prefill":
        step = lm.make_prefill_step(cfg, cache_len=shape.seq_len,
                                    constrain=constrain)
        return step, (weights, inputs, positions)
    states = lm.make_decode_state(cfg, shape.global_batch, shape.seq_len,
                                  lm.compute_dtype(cfg), "cpu")
    states = sh.device_put(states, sh.tree_shardings(mesh, states))
    step = lm.make_decode_step(cfg, sh.decode_compute_backend(mesh, "auto"),
                               constrain=constrain)
    return step, (weights, states, inputs, positions)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, force: bool = False,
             cfg=None) -> dict:
    """One cell's record (read from the cache unless ``force``); ``cfg``
    overrides the registry's config (a smoke config for tests)."""
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    path = os.path.join(os.path.abspath(out_dir), tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    # the JAX package's model: a dropless route's data-dependent segments
    # have no shapes under the fake mode, and the mesh cells are the JAX
    # package's
    cfg = jax_form(cfg or get_config(arch))
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "kind": shape.kind}
    if not ok:
        rec.update(status="skipped", reason=reason)
        _write(path, rec)
        return rec

    t0 = time.time()
    try:
        n_ranks = 512 if multi_pod else 256
        with fake_world(n_ranks):
            mesh = make_production_mesh(multi_pod=multi_pod)
            with FakeTensorMode(allow_non_fake_inputs=True), \
                    spmd.on_mesh(mesh):
                step, args = build_cell(cfg, shape, mesh)
                t_build = time.time() - t0
                g = G.analyze(step, *args)
        mf = F.model_flops(cfg, shape.seq_len, shape.global_batch,
                           shape.kind)
        counted = g["dot_flops"] * n_ranks
        rec.update(
            status="ok", n_ranks=n_ranks, build_s=round(t_build, 1),
            memory={"peak_bytes_per_rank": g["peak_bytes"],
                    "arg_bytes_per_rank": g["arg_bytes"]},
            graph={"dot_flops_per_rank": g["dot_flops"],
                   "mem_bytes_per_rank": g["mem_bytes"],
                   "collective_bytes_per_rank": g["total"],
                   "collectives_per_kind": g["per_kind"],
                   "collective_ops": g["ops"]},
            model_flops=mf,
            model_to_counted_flops=mf["total"] / max(counted, 1.0))
    except Exception as e:                               # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    _write(path, rec)
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)


def describe(rec: dict) -> str:
    """One line of a cell's record (the CLI's row)."""
    status = rec["status"]
    extra = ""
    if status == "ok":
        gb = rec["memory"]["peak_bytes_per_rank"] / 2**30
        g = rec["graph"]
        extra = (f"peak/rank={gb:.2f}GiB "
                 f"dotF/rank={g['dot_flops_per_rank']:.3e} "
                 f"coll/rank={g['collective_bytes_per_rank'] / 2**20:.1f}MiB "
                 f"model/counted={rec['model_to_counted_flops']:.3f} "
                 f"[{rec['wall_s']}s]")
    elif status == "error":
        extra = rec["error"][:120]
    else:
        extra = rec.get("reason", "")[:80]
    return (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"{status:8s} {extra}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                print(describe(run_cell(arch, shape, mp, args.out,
                                        args.force)), flush=True)


if __name__ == "__main__":
    main()
