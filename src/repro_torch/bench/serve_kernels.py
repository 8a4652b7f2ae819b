"""Fused decode-kernel benchmark: serving overhead, fused vs unfused.

What does MONITORED serving cost when one fused pass produces the decode
products AND the whole coding-menu counter set, against the unfused
plain route (``torch.matmul`` and separate counter passes)? Cells, under
the JAX benchmark's names (its ``pallas`` cells are the port's kernel
route, ``kernel_backend="auto"``: the kernels on the card, their plain
versions on the CPU):

* ``serve_<backend>[_power]`` -- the same mixed workload through
  ``ServeEngine`` on the ``ref`` and the kernel route, monitoring off and
  on; the derived column reports tok/s and the monitored-serving
  overhead %% per route. Greedy tokens must be equal across all four
  runs (the kernel-equivalence contract) -- a mismatch fails the run.
* ``gated_matmul_zf*`` -- the ZVG row matmul (K2 on the card) across a
  zero-density sweep on decode-shaped operands, against ``x @ w``.
* ``fused_counter_pass`` -- the one-pass monitored matmul
  (``_fused_decode_counters``, K3 on the card) vs the plain counter
  producer, with a CONFIRMED/REFUTED verdict on integer-counter
  equality.

``--emit-json BENCH_kernels.json`` writes every cell in the JAX
benchmark's artifact shape (``schemas/bench_kernels.schema.json``: the
kernel route's times under ``pallas_us``, ``torch.matmul``'s under
``xla_us``).

Run:  python -m repro_torch.bench.serve_kernels [--quick]
      [--emit-json BENCH_kernels.json] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import SMOKES
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServeEngine

from .common import _sync, benchmark_cli, emit_artifact, row, timed

ARCH = "qwen1.5-0.5b"
CACHE_LEN = 64
MAX_NEW = 8
N_REQUESTS = 12

#: each JAX cell's route: its stock-XLA cells run the plain versions, its
#: Pallas cells the port's kernels ("auto": the card's kernels on CUDA
#: tensors, the plain versions on the CPU)
ROUTES = {"ref": "ref", "pallas": "auto"}


def _workload(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, cfg.vocab, int(rng.integers(2, 24))))
            for _ in range(N_REQUESTS)]


def _serve(params, cfg, prompts, backend: str, power: bool, device="cuda"):
    engine = ServeEngine(params, cfg, ServeConfig(
        max_slots=4, cache_len=CACHE_LEN, power_monitor=power,
        kernel_backend=ROUTES[backend], device=device))
    for p in prompts:
        engine.submit(p, max_new_tokens=MAX_NEW)
    _sync()
    t0 = time.perf_counter()
    finished = engine.run()
    _sync()
    dt = time.perf_counter() - t0
    return engine, {r.uid: r.generated for r in finished}, dt


def main(quick: bool = False, emit_json: str | None = None,
         device="cuda") -> None:
    cfg = SMOKES[ARCH].with_(compute_dtype="float32")
    with torch.no_grad():
        params = lm.init_model(
            cfg, torch.Generator(device=device).manual_seed(0))
    prompts = _workload(cfg)
    on_card = torch.device(device).type == "cuda"
    results: dict[str, dict] = {}

    # ---- serving cells: tok/s and monitored overhead per route
    tokens_ref = None
    for backend in ROUTES:
        _serve(params, cfg, prompts, backend, False, device)   # warm-up
        cell = {}
        dts = {}
        for power in (False, True):
            if power:
                _serve(params, cfg, prompts, backend, True, device)
            engine, toks, dt = _serve(params, cfg, prompts, backend, power,
                                      device)
            st = engine.stats
            dts[power] = dt
            name = f"serve_{backend}" + ("_power" if power else "")
            tag = "monitored" if power else "unmonitored"
            row(name, dt / max(st["decode_steps"], 1) * 1e6,
                f"{st['tokens'] / dt:.0f} tok/s {tag} "
                f"(kernel_backend={ROUTES[backend]})")
            cell[tag] = {"tokens_per_s": st["tokens"] / dt, "wall_s": dt,
                         "decode_steps": st["decode_steps"]}
            if tokens_ref is None:
                tokens_ref = toks
            elif toks != tokens_ref:
                raise SystemExit(
                    f"greedy tokens changed under backend="
                    f"{ROUTES[backend]} power={power} (kernel-equivalence "
                    f"violated)")
        overhead = (dts[True] - dts[False]) / dts[False] * 100
        cell["monitor_overhead_pct"] = overhead
        print(f"# {ROUTES[backend]}: monitored-serving overhead "
              f"{overhead:+.0f}% wall vs monitoring off")
        results[f"serve_{backend}"] = cell
    fused, unfused = (results["serve_pallas"]["monitor_overhead_pct"],
                      results["serve_ref"]["monitor_overhead_pct"])
    print(f"# monitored-serving overhead: fused {fused:+.0f}% vs "
          f"unfused {unfused:+.0f}%")

    # ---- zero-density sweep: the ZVG row matmul on decode-shaped rows
    from repro_torch.kernels.zvg_matmul.ops import gated_row_matmul
    b, k, n = 8, 512, 512
    rng = np.random.default_rng(11)
    sweep = {}
    zfs = (0.0, 0.9) if quick else (0.0, 0.5, 0.9, 1.0)
    def route(kernel):
        return (f"kernel ({kernel})" if on_card
                else "plain version: the kernel needs the card")

    for zf in zfs:
        x = (rng.standard_normal((b, k)) * 0.5).astype(np.float32)
        mask = rng.random(b) < zf                 # whole-row sparsity:
        x[mask] = 0.0                             # the granularity ZVG gates
        x = torch.from_numpy(x).to(device)
        w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05)
                             .astype(np.float32)).to(device)
        _, us_ref = timed(lambda: x @ w)
        _, us_pal = timed(lambda: gated_row_matmul(x, w, backend="auto"))
        gated = int(mask.sum())
        row(f"gated_matmul_zf{int(zf * 100):02d}", us_pal,
            f"{gated}/{b} rows gated / torch.matmul {us_ref:.0f}us "
            f"({route('K2')})")
        sweep[f"zf{int(zf * 100):02d}"] = {
            "rows_gated": gated, "rows": b,
            "pallas_us": us_pal, "xla_us": us_ref}
    results["zero_sweep"] = sweep

    # ---- the monitored pass itself: one fused pass vs the plain producer
    from repro_torch.core.monitor import DEFAULT_MONITOR
    from repro_torch.serve.power import (_fused_decode_counters,
                                         _ref_decode_counters)
    plain = dataclasses.replace(DEFAULT_MONITOR, backend="ref")
    x = (rng.standard_normal((4, 896)) * 0.5).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0.0
    x = torch.from_numpy(x).to(device)
    w = torch.from_numpy((rng.standard_normal((896, 512)) * 0.05)
                         .astype(np.float32)).to(device)
    ref_out, us_ref = timed(lambda: _ref_decode_counters(x, w, plain))
    fused_out, us_pal = timed(lambda: _fused_decode_counters(
        x, w, DEFAULT_MONITOR, "auto"))
    equal = all(g.dtype == r.dtype and g.shape == r.shape
                and bool(torch.equal(g, r))
                for g, r in zip(fused_out[:4], ref_out))
    verdict = "CONFIRMED" if equal else "REFUTED"
    row("fused_counter_pass", us_pal,
        f"products+counters one pass ({route('K3')}) / ref "
        f"producer {us_ref:.0f}us / integer equality {verdict}")
    results["fused_counter_pass"] = {
        "fused_us": us_pal, "ref_us": us_ref, "counters_bit_equal": equal}
    if not equal:
        raise SystemExit(
            "fused counter pass diverged from the reference producer")

    if emit_json:
        emit_artifact(emit_json, results, arch=ARCH, cache_len=CACHE_LEN,
                      quick=quick)


if __name__ == "__main__":
    benchmark_cli(main, quick_help="trim the zero-density grid (CI smoke)")
