"""Serving-engine benchmark: throughput + power ratio vs batch width.

How do tokens/s and the paper's BIC + ZVG savings move as the
continuous-batching engine widens its shared decode batch? Each cell
serves the SAME mixed-prompt-length workload (greedy, fixed seed) at a
different ``max_slots``, reporting wall-clock per decode step, tokens/s,
mean slot occupancy, and -- for the power cell -- the serve-wide
energy-weighted savings from per-request accounting.

The cells run the JAX benchmark's routes: the plain versions
(``kernel_backend="ref"``) but for the fused cell ``serve_b<n>_pallas``,
which runs ``"auto"``: on the card the gated decode matmul (K2) and the
fused matmul + counter pass (K3), on the CPU their plain versions. Its
greedy tokens must equal the ``"ref"`` cells' -- the kernel-equivalence
contract -- and the paged cell's must equal them too; a mismatch fails
the run. ``--mesh DATAxMODEL`` adds the sharded cell
``serve_b<n>_mesh<D>x<M>``: the power cell's workload through the engine
on a host mesh (:func:`repro_torch.launch.mesh.make_host_mesh`; a world of
one process starts its own group), whose greedy tokens must equal the
single-device cells'.

Decode-step wall time excludes warm-up (one warm-up workload runs first).
The workload is the smoke Qwen1.5-0.5B at float32 with random weights
from ``torch.Generator`` seed 0; :func:`_serve` takes any weights.

Run:  python -m repro_torch.bench.serve_throughput [--quick] [--device cpu]
          [--mesh 1x1]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.serve import PagingConfig, ServeConfig, ServeEngine

from .common import _sync, row

ARCH = "qwen1.5-0.5b"
CACHE_LEN = 64
MAX_NEW = 8
N_REQUESTS = 12


def _workload(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, cfg.vocab, int(rng.integers(2, 24))))
            for _ in range(N_REQUESTS)]


def _run(engine, prompts):
    for p in prompts:
        engine.submit(p, max_new_tokens=MAX_NEW)
    _sync()
    t0 = time.perf_counter()
    finished = engine.run()
    _sync()
    return engine, finished, time.perf_counter() - t0


def _serve(params, cfg, prompts, slots: int, power: bool,
           backend: str = "ref", device="cuda", mesh=None):
    """``(engine, finished requests, wall s)`` of the workload through
    ``slots`` slots on the ``backend`` route (on ``mesh`` when given)."""
    return _run(ServeEngine(params, cfg, ServeConfig(
        max_slots=slots, cache_len=CACHE_LEN, power_monitor=power,
        kernel_backend=backend, device=device), mesh=mesh), prompts)


def _parse_mesh(spec: str, device):
    data, model = (int(v) for v in spec.lower().split("x"))
    return make_host_mesh(data=data, model=model, device=device)


def main(quick: bool = False, mesh_spec: str | None = None,
         device="cuda") -> None:
    cfg = SMOKES[ARCH].with_(compute_dtype="float32")
    with torch.no_grad():
        params = lm.init_model(
            cfg, torch.Generator(device=device).manual_seed(0))
    prompts = _workload(cfg)
    widths = [1, 4] if quick else [1, 2, 4, 8]

    def serve(slots, power, backend="ref", mesh=None):
        return _serve(params, cfg, prompts, slots, power, backend, device,
                      mesh)

    serve(max(widths), power=False)                  # warm-up
    tokens_ref = None
    for slots in widths:
        engine, finished, dt = serve(slots, power=False)
        st = engine.stats
        us_step = dt / max(st["decode_steps"], 1) * 1e6
        row(f"serve_b{slots}_throughput", us_step,
            f"{st['tokens'] / dt:.0f} tok/s / occupancy "
            f"{engine.occupancy():.2f} of {slots}")
        toks = {r.uid: r.generated for r in finished}
        if tokens_ref is None:
            tokens_ref = toks
        elif toks != tokens_ref:
            print("# WARNING: greedy outputs changed with batch width "
                  "(continuous-batching invariant violated)")

    # power cell: per-request accounting on, serve-wide aggregate out
    slots = widths[-1]
    engine, finished, dt = serve(slots, power=True)
    agg = engine.trace_report().summary()
    per_req = [r.power.saving_total for r in finished]
    row(f"serve_b{slots}_power",
        dt / max(engine.stats["decode_steps"], 1) * 1e6,
        f"{agg['total_saving'] * 100:.2f}% total / "
        f"{agg['streaming_saving'] * 100:.2f}% streaming saving "
        f"(per-request {min(per_req) * 100:.2f}..{max(per_req) * 100:.2f}%)")
    print("# same greedy tokens at every batch width; power accounting "
          "costs one extra monitored matmul pair per decode step")

    # paged cell: the same workload through the block-paged engine with
    # the memory of `slots` slot reservations -- tokens must stay equal
    pages = slots * CACHE_LEN // 8 + 1
    eng, finished, dt = _run(ServeEngine(params, cfg, ServeConfig(
        cache_len=CACHE_LEN, kernel_backend="ref", device=device,
        paging=PagingConfig(page_size=8, num_pages=pages,
                            max_rows=2 * slots))), prompts)
    toks = {r.uid: r.generated for r in finished}
    row(f"serve_paged_hbm{slots}",
        dt / max(eng.stats["decode_steps"], 1) * 1e6,
        f"{eng.stats['tokens'] / dt:.0f} tok/s / peak admitted "
        f"{eng.stats['peak_admitted']} vs {slots} slots at equal HBM "
        f"(same tokens: {toks == tokens_ref})")
    if toks != tokens_ref:
        raise SystemExit(
            "paged greedy outputs differ from the slot engine "
            "(paging bit-exactness violated)")

    # fused-kernel cell: the decode matmuls and the counter pass through
    # the kernels on the card -- tokens must equal the plain cells'
    serve(slots, power=True, backend="auto")         # warm-up
    engine, finished, dt = serve(slots, power=True, backend="auto")
    toks = {r.uid: r.generated for r in finished}
    agg = engine.trace_report().summary()
    row(f"serve_b{slots}_pallas",
        dt / max(engine.stats["decode_steps"], 1) * 1e6,
        f"{engine.stats['tokens'] / dt:.0f} tok/s fused kernels "
        f"(kernel_backend=auto on {torch.device(device).type}) / "
        f"{agg['total_saving'] * 100:.2f}% total saving "
        f"(same tokens: {toks == tokens_ref})")
    if toks != tokens_ref:
        raise SystemExit(
            "fused-kernel greedy outputs differ from the ref backend "
            "(kernel-equivalence violated)")

    if mesh_spec:
        started = not dist.is_initialized()
        mesh = _parse_mesh(mesh_spec, device)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        serve(slots, power=False, mesh=mesh)          # sharded warm-up
        engine, finished, dt = serve(slots, power=True, mesh=mesh)
        toks = {r.uid: r.generated for r in finished}
        agg = engine.trace_report().summary()
        row(f"serve_b{slots}_mesh{shape['data']}x{shape['model']}",
            dt / max(engine.stats["decode_steps"], 1) * 1e6,
            f"{engine.stats['tokens'] / dt:.0f} tok/s sharded / "
            f"{agg['total_saving'] * 100:.2f}% total saving "
            f"(same tokens: {toks == tokens_ref})")
        if started:                # the one-process group the mesh began
            dist.destroy_process_group()
        if toks != tokens_ref:
            # a changed greedy token is a sharding bug, not noise
            raise SystemExit(
                "sharded greedy outputs differ from the single-device "
                "engine (mesh bit-exactness violated)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="two batch widths only (CI smoke)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="add a sharded-engine cell over a host mesh of "
                         "this shape (e.g. 1x1 on one card; a larger mesh "
                         "needs a process group of that many ranks)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(quick=args.quick, mesh_spec=args.mesh, device=args.device)
