#!/usr/bin/env python3
"""Run-to-run spread of the trainer on the card, and where it comes from.

Qwen1.5-0.5B at full width (bfloat16 compute, float32 masters, seed 0),
batch 8 x seq 256, as ``chip_smoke.py``'s ``phase_train`` and
``phase_mesh`` (c) train it:

1. one loss and backward from the same state and batch, three times:
   whether the losses agree bit for bit and, for each parameter leaf that
   differs, the largest absolute difference of its gradient;
2. the same in a child process under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``), which lists the ops that ran
   and have no deterministic version;
3. ``launch.train.train`` for 3 steps with no mesh, twice, and once on
   the card's 1x1 mesh: each run's losses and grad norms, and each
   run's largest relative gap from the first plain run;
4. the trainer's first two steps by hand, with no mesh and on the 1x1
   mesh from the same state and batches: at each step, the parameter
   leaves whose gradients, and then whose updated parameters, differ
   between the two, with the largest absolute and relative difference.

It prints the card's name and power limit, one line per finding, and
the whole as JSON on its last line (also written to
``chiprun_out/train_determinism.json``). Run from the repository root on
a GPU machine:

    python3 tools/train_determinism.py

``--cpu`` runs the smoke config on the CPU instead (a check of the
script, not a measurement).
"""
import json
import os
import subprocess
import sys
import warnings

sys.path.insert(0, "src")
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_source  # noqa: E402
from repro_torch.launch import train as tr  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import sharding as rsh  # noqa: E402
from repro_torch.runtime import spmd  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    tree_leaves, tree_map, tree_unflatten)

ARCH, BATCH, SEQ, STEPS, LR, WARMUP = "qwen1.5-0.5b", 8, 256, 3, 1e-3, 2
CPU = "--cpu" in sys.argv
DEVICE = "cpu" if CPU else "cuda"
if CPU:
    BATCH, SEQ = 2, 16


def leaf_names(tree, prefix=""):
    """Paths of ``tree``'s leaves, in ``tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in
                leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in
                leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def grads_spread(repeats=3) -> dict:
    """Loss and gradients of one state and batch, ``repeats`` times."""
    cfg = get_config(ARCH, smoke=CPU)
    params = lm.init_model(cfg, torch.Generator(DEVICE).manual_seed(0))
    names = leaf_names(params)
    assert len(names) == len(tree_leaves(params))
    batch = tr.batch_to(make_source(cfg, DataConfig(
        seq_len=SEQ, global_batch=BATCH, seed=0)).batch(0), DEVICE)

    def once():
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = lm.loss_fn(tree_unflatten(params, leaves), cfg, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runs = [once() for _ in range(repeats)]
    loss0, g0 = runs[0]
    differ = {}
    for loss, g in runs[1:]:
        for name, a, b in zip(names, g0, g):
            if not torch.equal(a, b):
                d = (a - b).abs().max().item()
                differ[name] = max(differ.get(name, 0.0), d)
    return {"losses": [float(r[0]) for r in runs],
            "losses_bitwise_equal": all(torch.equal(loss0, r[0])
                                        for r in runs[1:]),
            "leaves": len(names),
            "leaves_differing": dict(sorted(differ.items(),
                                            key=lambda kv: -kv[1])),
            "nondeterministic_ops": sorted({
                str(w.message).split("\n")[0][:200] for w in caught
                if "deterministic" in str(w.message)})}


def train_spread() -> dict:
    """3 plain trainer steps twice and 3 on the card's 1x1 mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    tc = tr.TrainConfig(arch=ARCH, steps=STEPS, seq=SEQ, batch=BATCH,
                        lr=LR, warmup=WARMUP, smoke=CPU, device=DEVICE)
    mesh = make_host_mesh(data=1, model=1, device=DEVICE)
    try:
        runs = {name: [{k: h[k] for k in ("loss", "grad_norm")}
                       for h in tr.train(tc, m)["history"]]
                for name, m in (("plain", None), ("plain_again", None),
                                ("mesh", mesh))}
    finally:
        torch.distributed.destroy_process_group()
    first = runs["plain"]
    gap = {name: max(abs(h[k] - f[k]) / abs(f[k]) for h, f in
                     zip(hist, first) for k in ("loss", "grad_norm"))
           for name, hist in runs.items() if name != "plain"}
    return {"runs": runs, "max_rel_gap_from_plain": gap}


def _diff(names, a, b) -> dict:
    """Leaves of ``a`` and ``b`` (the mesh's gathered) that differ."""
    out = {}
    for name, x, y in zip(names, a, b):
        y = spmd.local(y)
        if not torch.equal(x, y):
            d = (x.float() - y.float()).abs()
            out[name] = {"max_abs": d.max().item(),
                         "max_rel": (d / x.float().abs().clamp_min(
                             1e-30)).max().item(),
                         "n_differ": int((d > 0).sum())}
    return out


def mesh_vs_plain(steps=2) -> dict:
    """Gradients and updated parameters of the first ``steps`` steps,
    with no mesh and on the 1x1 mesh, leaf by leaf."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW, cosine_schedule
    cfg = get_config(ARCH, smoke=CPU)
    opt = AdamW(lr=cosine_schedule(LR, WARMUP, STEPS))
    mesh = make_host_mesh(data=1, model=1, device=DEVICE)
    constrain = rsh.make_constrain(mesh)
    out = []
    try:
        plain = tr.init_state(cfg, opt, DEVICE, 0)
        dist = tr.init_state(cfg, opt, DEVICE, 0, mesh)
        names = leaf_names(plain[0])
        data = make_source(cfg, DataConfig(seq_len=SEQ, global_batch=BATCH,
                                           seed=0))
        for step in range(steps):
            batch = tr.batch_to(data.batch(step), DEVICE)
            res = {}
            for name, (params, opt_state), m in (("plain", plain, None),
                                                 ("mesh", dist, mesh)):
                b = batch if m is None else rsh.device_put(
                    batch, rsh.batch_shardings(m, batch))
                with spmd.on_mesh(m):
                    leaves = [p.detach().requires_grad_()
                              for p in tree_leaves(params)]
                    loss, _ = lm.loss_fn(
                        tree_unflatten(params, leaves), cfg, b, 512,
                        lm._id if m is None else constrain)
                    grads = torch.autograd.grad(loss, leaves)
                    with torch.no_grad():
                        upd, opt_state = opt.update(
                            tree_unflatten(params, grads), opt_state,
                            params, torch.tensor(step, dtype=torch.int32,
                                                 device=DEVICE))
                        params = tree_map(torch.add, params, upd)
                res[name] = (float(spmd.local(loss)), grads, params,
                             opt_state)
            plain, dist = res["plain"][2:], res["mesh"][2:]
            out.append({
                "step": step,
                "loss": [res["plain"][0], res["mesh"][0]],
                "grads_differ": _diff(names, res["plain"][1],
                                      res["mesh"][1]),
                "params_differ": _diff(names, tree_leaves(plain[0]),
                                       tree_leaves(dist[0]))})
    finally:
        torch.distributed.destroy_process_group()
    return {"steps": out}


def main():
    if "--child" in sys.argv:
        torch.use_deterministic_algorithms(True, warn_only=True)
        print(json.dumps(grads_spread()))
        return
    smi = "cpu" if CPU else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda)
    out = {"card": smi, "torch": torch.__version__}
    out["grads"] = grads_spread()
    print("default:", json.dumps(out["grads"]))
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    child = subprocess.run([sys.executable, __file__, "--child"]
                           + ["--cpu"] * CPU, env=env,
                           capture_output=True, text=True, check=True)
    out["grads_deterministic"] = json.loads(
        child.stdout.strip().splitlines()[-1])
    print("deterministic:", json.dumps(out["grads_deterministic"]))
    out["train"] = train_spread()
    print("train:", json.dumps(out["train"]))
    out["mesh_vs_plain"] = mesh_vs_plain()
    print("mesh_vs_plain:", json.dumps(out["mesh_vs_plain"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/train_determinism.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
