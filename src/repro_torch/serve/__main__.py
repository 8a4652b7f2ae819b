"""Serving driver: a mixed workload through the slot engine.

Submits ``--requests`` requests with random prompt lengths, token budgets
and sampling (even requests greedy, odd ones temperature 0.8 with top-k
20), pumps the engine until the queue drains, and prints one line per
retired request -- its tokens, finish reason and its own BIC + ZVG power
report -- then throughput, occupancy and the serve-wide power aggregate.
Weights are random, drawn from ``--seed``. ``--spans`` keeps the engine's
and the model's host spans (:mod:`repro_torch.runtime.spans`) over the run
and prints their count, total and self milliseconds by name after the
stats line.

Run:  PYTHONPATH=src python -m repro_torch.serve            # on the card
      PYTHONPATH=src python -m repro_torch.serve --smoke --device cpu
      PYTHONPATH=src python -m repro_torch.serve --spans   # where time goes
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.runtime import spans
from repro_torch.serve import SamplingParams, ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced config (CPU-sized)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=96)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--no-power", action="store_true",
                    help="skip per-request power accounting")
    ap.add_argument("--spans", action="store_true",
                    help="time the engine's and the model's spans and "
                         "print them by name")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    scfg = ServeConfig(max_slots=args.slots, cache_len=args.cache_len,
                       power_monitor=not args.no_power, seed=args.seed,
                       device=args.device)
    gen = torch.Generator(device=scfg.device).manual_seed(args.seed)
    engine = ServeEngine(lm.init_model(cfg, gen), cfg, scfg)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              int(rng.integers(2, args.max_prompt))).tolist()
        samp = (SamplingParams() if i % 2 == 0 else
                SamplingParams(temperature=0.8, top_k=20))
        engine.submit(prompt,
                      max_new_tokens=int(rng.integers(4, args.max_new)),
                      sampling=samp)

    print(f"arch={cfg.name}{' (reduced config)' if args.smoke else ''}, "
          f"slots={args.slots}, cache_len={args.cache_len}, "
          f"requests={args.requests}, device={args.device}")
    if args.spans:
        spans.enable()
    t0 = time.perf_counter()
    finished = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    records = spans.take()
    spans.disable()

    hdr = f"{'req':>4s} {'prompt':>6s} {'new':>4s} {'reason':8s} {'slot':>4s}"
    if not args.no_power:
        hdr += f" {'save%':>6s} {'stream-save%':>12s} {'zero%':>6s}"
    print(hdr)
    for r in sorted(finished, key=lambda r: r.uid):
        line = (f"{r.uid:4d} {r.prompt_len:6d} {len(r.generated):4d} "
                f"{r.finish_reason:8s} {r.slot:4d}")
        if r.power is not None:
            line += (f" {r.power.saving_total * 100:6.2f} "
                     f"{r.power.saving_streaming * 100:12.2f} "
                     f"{r.power.zero_fraction * 100:6.1f}")
        print(line)

    st = engine.stats
    print(f"\n{len(finished)} requests in {st['steps']} engine steps "
          f"({st['decode_steps']} decode steps, mean occupancy "
          f"{engine.occupancy():.2f}/{args.slots} slots)")
    print(f"{st['tokens']} tokens in {dt:.2f}s = {st['tokens'] / dt:.0f} "
          f"tok/s (includes the kernels' first-use build)")
    if args.spans:
        print(f"\nspans over the run ({st['admissions']} admissions, "
              f"{st['prefill_rows']} prompt rows prefilled):")
        print(spans.format_summary(spans.summary(records)))
    if not args.no_power:
        agg = engine.trace_report().summary()
        print(f"serve-wide (energy-weighted): "
              f"{agg['total_saving'] * 100:.2f}% total / "
              f"{agg['streaming_saving'] * 100:.2f}% streaming saving, "
              f"zero fraction {agg['mean_zero_fraction'] * 100:.1f}%")


if __name__ == "__main__":
    main()
