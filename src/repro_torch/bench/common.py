"""Shared helpers of the port's benchmarks.

Every benchmark prints ``name,us_per_call,derived`` CSV rows plus a
human-readable block, and runs on the card unless ``--device cpu``.
Expensive CNN analyses are cached as JSON under ``results/bench_torch/``
(:data:`RESULTS`), keyed by the device they ran on: an analysis of the
plain versions on the CPU is never read back for a run on the card.
"""
from __future__ import annotations

import json
import os
import time

import torch

#: the cache directory of :func:`cached` (read at each call, so a caller
#: may point it elsewhere)
RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "bench_torch")


def cache_path(name: str) -> str:
    os.makedirs(RESULTS, exist_ok=True)
    return os.path.join(RESULTS, name + ".json")


def cached(name: str, fn):
    """``fn()``'s JSON-able result, read from :func:`cache_path` when a
    run has stored it there, else computed and stored."""
    path = cache_path(name)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    out = fn()
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=float)
    return out


def timed(fn, *args, warmup: int = 1, iters: int = 3):
    """``(fn(*args), microseconds per call)``: ``warmup`` calls, then the
    mean of ``iters`` on the host clock. Work on the card is synchronized
    before each clock read."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync()
    dt = (time.perf_counter() - t0) / iters
    return out, dt * 1e6


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def row(name: str, us: float, derived: str):
    print(f"{name},{us:.1f},{derived}")


def emit_artifact(path: str, cells: dict, **meta) -> None:
    """Write a benchmark's structured-JSON artifact: metadata keys first,
    every measured cell under ``"cells"``."""
    with open(path, "w") as f:
        json.dump({**meta, "cells": cells}, f, indent=1, default=float)
    print(f"# wrote {path}")


def benchmark_cli(main, quick_help: str = "smaller workload (CI smoke)",
                  argv=None) -> None:
    """The standard entry point: ``--quick``, ``--emit-json`` and
    ``--device``, the CSV header, then ``main(quick=..., emit_json=...,
    device=...)``."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help=quick_help)
    ap.add_argument("--emit-json", default=None, metavar="PATH",
                    help="also write every cell as structured JSON")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default; cpu runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    main(quick=args.quick, emit_json=args.emit_json, device=args.device)


def analyze_cached(net: str, n_images: int = 1, device="cuda"):
    """Cached per-layer CNN power analysis used by several benchmarks:
    ``{"layers": [vars(layer), ...], "summary": network_summary(...)}``
    of :func:`repro_torch.apps.cnn.analysis.analyze_network` (the paper
    pair, 224 px) on ``device``, keyed by net, image count, resolution
    and the device's type."""
    from repro_torch.apps.cnn import analysis

    def run():
        layers = analysis.analyze_network(net, n_images=n_images,
                                          device=device, res=224)
        return {"layers": [vars(l) for l in layers],
                "summary": analysis.network_summary(layers)}

    kind = torch.device(device).type
    return cached(f"cnn_{net}_{n_images}img_224px_{kind}", run)
