"""Paged-serving benchmark: what block-paging buys over slot serving.

Four questions, one workload (greedy, fixed seed, mixed prompt lengths),
every engine on the plain route (``kernel_backend="ref"``, the JAX
benchmark's default), so no paged-attention kernel runs here:

* **admitted concurrency** -- with the SAME device memory (slot engine:
  ``num_slots x cache_len`` positions; paged engine: an equal number of
  allocatable pages), how many requests actually run at once, and what
  does that do to tokens/s and wall-clock?
* **chunked prefill** -- throughput with long prompts streamed through
  ``prefill_chunk`` instead of monolithic prefills;
* **prefix-hit rate** -- a shared-system-prompt workload through the
  refcounted prefix trie: fraction of requests that hit, pages reused
  vs recomputed;
* **power-accounting overhead** -- wall-clock cost of exact per-request
  BIC+ZVG accounting under paging (power on vs off, same cells).

``--emit-json BENCH_serve.json`` writes every cell in the JAX
benchmark's artifact shape (``schemas/bench_serve.schema.json``).

Run:  python -m repro_torch.bench.serve_paging [--quick]
      [--emit-json BENCH_serve.json] [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import SMOKES
from repro_torch.models import lm
from repro_torch.serve import PagingConfig, ServeConfig, ServeEngine

from .common import _sync, benchmark_cli, emit_artifact, row

ARCH = "qwen1.5-0.5b"
CACHE_LEN = 64
PAGE_SIZE = 8
MAX_NEW = 8


def _workload(cfg, n, lo=2, hi=24, seed=0, prefix=()):
    rng = np.random.default_rng(seed)
    return [list(prefix) + list(rng.integers(0, cfg.vocab,
                                             int(rng.integers(lo, hi))))
            for _ in range(n)]


def _run(params, cfg, prompts, scfg, max_new=MAX_NEW):
    eng = ServeEngine(params, cfg, scfg)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    _sync()
    t0 = time.perf_counter()
    finished = eng.run()
    _sync()
    return eng, finished, time.perf_counter() - t0


def _slot_cfg(slots, device, power=False):
    return ServeConfig(max_slots=slots, cache_len=CACHE_LEN,
                       power_monitor=power, kernel_backend="ref",
                       device=device)


def _paged_cfg(pages, rows, device, chunk=0, prefix=False, power=False):
    return ServeConfig(cache_len=CACHE_LEN, power_monitor=power,
                       kernel_backend="ref", device=device,
                       paging=PagingConfig(page_size=PAGE_SIZE,
                                           num_pages=pages, max_rows=rows,
                                           prefill_chunk=chunk,
                                           prefix_cache=prefix))


def main(quick: bool = False, emit_json: str | None = None,
         device="cuda") -> None:
    cfg = SMOKES[ARCH].with_(compute_dtype="float32")
    with torch.no_grad():
        params = lm.init_model(
            cfg, torch.Generator(device=device).manual_seed(0))
    n_req = 8 if quick else 16
    prompts = _workload(cfg, n_req)
    results: dict[str, dict] = {}

    # --- admitted concurrency at equal memory: 2 slots vs the same pages
    slots = 2
    pages = slots * CACHE_LEN // PAGE_SIZE + 1       # +1: the trash page
    rows = 4 if quick else 8
    slot_cfg = _slot_cfg(slots, device)
    paged_cfg = _paged_cfg(pages, rows, device)
    _run(params, cfg, prompts, slot_cfg)             # warm-up
    eng_s, fin_s, dt_s = _run(params, cfg, prompts, slot_cfg)
    _run(params, cfg, prompts, paged_cfg)
    eng_p, fin_p, dt_p = _run(params, cfg, prompts, paged_cfg)
    toks_equal = ({r.uid: r.generated for r in fin_s}
                  == {r.uid: r.generated for r in fin_p})
    for name, eng, dt, peak in (
            ("slot", eng_s, dt_s, eng_s.stats["peak_live"]),
            ("paged", eng_p, dt_p, eng_p.stats["peak_admitted"])):
        st = eng.stats
        tok_s = st["tokens"] / dt
        row(f"serve_paging_{name}_hbm{slots}slots",
            dt / max(st["decode_steps"], 1) * 1e6,
            f"{tok_s:.0f} tok/s / peak concurrency {peak} "
            f"(same HBM = {slots} slots x {CACHE_LEN})")
        results[name] = {"tokens_per_s": tok_s, "peak_concurrency": peak,
                         "decode_steps": st["decode_steps"],
                         "wall_s": dt, "hbm_slots_equiv": slots}
    results["paged"]["tokens_bit_equal_to_slot"] = toks_equal
    print(f"# paged admits {eng_p.stats['peak_admitted']} concurrent vs "
          f"{slots} slots at equal HBM; tokens bit-equal: {toks_equal}")

    # --- chunked prefill over long prompts
    long_prompts = _workload(cfg, n_req // 2, lo=32, hi=CACHE_LEN - MAX_NEW,
                             seed=1)
    chunk_cfg = _paged_cfg(64, 4, device, chunk=16)
    _run(params, cfg, long_prompts, chunk_cfg)
    eng, _, dt = _run(params, cfg, long_prompts, chunk_cfg)
    row("serve_paging_chunked_prefill",
        dt / max(eng.stats["decode_steps"], 1) * 1e6,
        f"{eng.stats['tokens'] / dt:.0f} tok/s / "
        f"{eng.stats['chunk_calls']} chunk calls of 16 over "
        f"{len(long_prompts)} long prompts")
    results["chunked"] = {"tokens_per_s": eng.stats["tokens"] / dt,
                          "chunk_calls": eng.stats["chunk_calls"],
                          "prefill_chunk": 16}

    # --- prefix-hit rate on a shared-system-prompt workload
    sys_prompt = _workload(cfg, 1, lo=24, hi=25, seed=2)[0]
    shared = _workload(cfg, n_req, lo=2, hi=12, seed=3, prefix=sys_prompt)
    prefix_cfg = _paged_cfg(64, 4, device, prefix=True)
    _run(params, cfg, shared, prefix_cfg)
    eng, _, dt = _run(params, cfg, shared, prefix_cfg)
    hit_rate = eng.stats["prefix_hit_requests"] / len(shared)
    px = eng.prefix
    row("serve_paging_prefix_reuse",
        dt / max(eng.stats["decode_steps"], 1) * 1e6,
        f"{hit_rate * 100:.0f}% requests hit / {px.hit_pages} pages "
        f"reused, {px.inserted_pages} inserted "
        f"({len(sys_prompt)}-token shared system prompt)")
    results["prefix"] = {"hit_rate": hit_rate, "hit_pages": px.hit_pages,
                         "inserted_pages": px.inserted_pages,
                         "lookups": px.lookups}

    # --- exact power accounting: wall-clock overhead under paging
    power_cfg = _paged_cfg(pages, rows, device, power=True)
    _run(params, cfg, prompts, power_cfg)
    eng, fin, dt_pw = _run(params, cfg, prompts, power_cfg)
    overhead = (dt_pw - dt_p) / dt_p * 100
    agg = eng.trace_report().summary()
    row("serve_paging_power_overhead",
        dt_pw / max(eng.stats["decode_steps"], 1) * 1e6,
        f"{overhead:+.0f}% wall vs accounting off / "
        f"{agg['total_saving'] * 100:.2f}% total saving over "
        f"{len(fin)} exact per-request reports")
    results["power"] = {"overhead_pct": overhead,
                        "total_saving": agg["total_saving"],
                        "streaming_saving": agg["streaming_saving"]}

    if emit_json:
        emit_artifact(emit_json, results, arch=ARCH, cache_len=CACHE_LEN,
                      page_size=PAGE_SIZE, quick=quick)


if __name__ == "__main__":
    benchmark_cli(main)
