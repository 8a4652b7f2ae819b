"""End-to-end training example: a Qwen1.5-family model trained for a
few hundred steps with checkpoints, preemption handling and restarts,
the counterpart of the JAX package's ``examples/train_lm.py``.

By default the model is the smoke config of Qwen1.5-0.5B; ``--full``
trains it at its published widths. It runs on the card unless
``--device cpu`` is given, and resumes from ``--ckpt-dir`` after a
preemption.

Run:  PYTHONPATH=src python -m repro_torch.apps.train_lm --steps 200
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

from repro_torch.apps import check_device
from repro_torch.launch.train import TrainConfig, train
from repro_torch.runtime.fault import run_with_restarts


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(prog="python -m repro_torch.apps.train_lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--full", action="store_true",
                    help="full qwen1.5-0.5b config (needs the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_device(args.device, "the training example")

    tc = TrainConfig(arch="qwen1.5-0.5b", smoke=not args.full,
                     steps=args.steps, batch=args.batch, seq=args.seq,
                     lr=1e-3, warmup=20, ckpt_dir=args.ckpt_dir,
                     ckpt_every=50, power_monitor=False, device=args.device)
    out = run_with_restarts(lambda: train(tc))
    print(f"final loss {out['final_loss']:.4f} | median step "
          f"{out['median_step_time']*1e3:.0f} ms | "
          f"{len(out['stragglers'])} straggler steps")
    first = out["history"][0]["loss"] if out["history"] else float("nan")
    print(f"loss trajectory: {first:.3f} -> {out['final_loss']:.3f}")


if __name__ == "__main__":
    main()
