"""Helpers of the port's multi-process mesh tests
(``tests/test_torch_mesh_serve_*.py``): one gloo group of ``data x
model`` CPU processes runs every case of a mesh shape once, and rank 0
returns plain Python results for the test process to compare.

The workload is ``tests/multidevice/test_sharded_serve.py``'s: the smoke
Qwen1.5-0.5B in float32, its six prompts and staggered budgets, four
slots, ``cache_len=48``, pages of 8.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

ARCH = "qwen1.5-0.5b"
CACHE_LEN = 48
MAX_SLOTS = 4
_RNG = np.random.default_rng(11)
PROMPTS = [list(map(int, _RNG.integers(0, 256, int(_RNG.integers(2, 20)))))
           for _ in range(6)]
BUDGETS = [5, 3, 6, 4, 5, 3]
#: the trainer's run: smoke width in float32, batch 4 x seq 16
TRAIN = dict(arch=ARCH, smoke=True, seq=16, batch=4, seed=3, device="cpu")


def smoke_cfg():
    from repro_torch.configs import SMOKES
    return SMOKES[ARCH].with_(compute_dtype="float32")


def sampling(i: int):
    from repro_torch.serve import SamplingParams
    return (SamplingParams() if i % 2 == 0
            else SamplingParams(temperature=1.1, top_k=9))


def serve(params, mesh=None, *, paged=False, power=True, backend="auto",
          stochastic=False):
    """One engine run of the workload: plain results (tokens, finish
    reasons, slots, steps, energies, the serve-wide aggregate, stats)."""
    from repro_torch.serve import PagingConfig, ServeConfig, ServeEngine
    kw = dict(cache_len=CACHE_LEN, power_monitor=power, device="cpu",
              kernel_backend=backend, seed=3)
    if paged:
        kw["paging"] = PagingConfig(page_size=8, num_pages=64,
                                    max_rows=MAX_SLOTS)
    else:
        kw["max_slots"] = MAX_SLOTS
    eng = ServeEngine(params, smoke_cfg(), ServeConfig(**kw), mesh=mesh)
    for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
        eng.submit(p, max_new_tokens=b,
                   **({"sampling": sampling(i)} if stochastic else {}))
    fin = eng.run()
    out = {"order": [r.uid for r in fin],
           "tokens": {r.uid: list(r.generated) for r in fin},
           "finish": {r.uid: r.finish_reason for r in fin},
           "slots": {r.uid: r.slot for r in fin},
           "steps": {r.uid: (r.start_step, r.finish_step) for r in fin},
           "stats": dict(eng.stats),
           "allocations": eng.cache.allocations}
    if power:
        out["energy"] = {r.uid: r.power.energy for r in fin}
        out["aggregate"] = eng.trace_report().aggregate()
    return out


def _floats(hist):
    return [{k: float(v) for k, v in h.items() if k != "dt"} for h in hist]


def train(mesh=None, steps=2, ckpt_dir=""):
    """History of a float32 smoke training run (losses, grad norms)."""
    from repro_torch.launch import train as T
    get = T.get_config
    T.get_config = lambda a, smoke=False: get(a, smoke).with_(
        compute_dtype="float32")
    try:
        out = T.train(T.TrainConfig(**TRAIN, steps=steps,
                                    ckpt_dir=ckpt_dir), mesh)
    finally:
        T.get_config = get
    return _floats(out["history"])


def run_mesh_cases(rank, world, shape, store, out_path, params_np, cases,
                   ckpt_dir):
    """Entry of each spawned rank: every case of ``cases`` on a
    ``shape`` mesh; rank 0 pickles the results to ``out_path``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import convert
        from repro_torch.runtime import spmd
        params = convert.params_from_jax(params_np, smoke_cfg())
        mesh = make_host_mesh(data=shape[0], model=shape[1], device="cpu")
        res = {}
        spmd.reset_counts()
        if "slot" in cases:
            res["slot"] = serve(params, mesh)
        if "paged" in cases:
            res["paged"] = serve(params, mesh, paged=True)
        if "stochastic" in cases:
            res["stochastic"] = serve(params, mesh, power=False,
                                      stochastic=True)
        if "train" in cases:
            res["train"] = train(mesh, ckpt_dir=ckpt_dir)
            # the checkpoint saved on this mesh, restored onto 1 x world
            mesh2 = make_host_mesh(data=1, model=world, device="cpu")
            res["resumed"] = train(mesh2, steps=3, ckpt_dir=ckpt_dir)
        if "subset" in cases:
            # a 1x2 mesh over the first two ranks: the others sit out and
            # must not hang in any collective of the run
            from repro_torch.launch.mesh import in_mesh
            sub = make_host_mesh(data=1, model=2, device="cpu")
            res["subset"] = (serve(params, sub, power=False)
                             if in_mesh(sub) else None)
            dist.barrier()
        res["counts"] = dict(spmd.COUNTS)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_cases(tmp, shape, params_np, cases) -> dict:
    """Run ``cases`` on a ``shape`` mesh of ``data * model`` spawned gloo
    processes (a ``FileStore`` under ``tmp``: no port, so parallel test
    workers never clash); their results."""
    import torch.multiprocessing as mp
    world = shape[0] * shape[1]
    out = os.path.join(tmp, "results.pkl")
    mp.spawn(run_mesh_cases,
             args=(world, shape, os.path.join(tmp, "store"), out, params_np,
                   cases, os.path.join(tmp, "ckpt")),
             nprocs=world, join=True)
    with open(out, "rb") as f:
        return pickle.load(f)
