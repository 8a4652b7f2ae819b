"""Paper §IV area-overhead argument: encoder count scales linearly with SA
side length while PE count scales quadratically, so the relative overhead
of the proposed logic shrinks with array size.

The *energy* analogue, from the power model: the proposed design's
overhead share (zero-detectors + encoders + decode XORs) falls as the
array grows from 8x8 to 128x128, for the same workload.

Run:  python -m repro_torch.bench.overhead_scaling [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import power, systolic

from .common import row, timed

SIZES = (8, 16, 32, 64, 128)


def operands():
    """The JAX benchmark's workload (the same numpy draws), float32 on
    the CPU: ReLU-sparse ``A [256, 512]`` and ``W [512, 256]``."""
    rng = np.random.default_rng(0)
    A = np.abs(rng.standard_normal((256, 512))).astype(np.float32)
    A[rng.random(A.shape) < 0.55] = 0.0
    W = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(W)


def main(device="cuda") -> dict:
    """Print a row per array size and the verdict; returns ``{n: (the
    proposed design's overhead share, saving_total, sa_power's
    report)}``."""
    A, W = (t.to(device) for t in operands())

    print("# overhead share of proposed-design energy vs SA size")
    out = {}
    for n in SIZES:
        def run(n=n):
            rep = systolic.sa_stream_report(A, W, systolic.SAGeometry(n, n))
            pw = power.sa_power(rep)
            return (float(pw["proposed"]["overhead"])
                    / float(pw["proposed"]["total"]),
                    float(pw["saving_total"]), pw)

        (share, saving, pw), us = timed(run, iters=1)
        out[n] = (share, saving, pw)
        row(f"overhead_share_{n}x{n}", us,
            f"{share*100:.2f}% (saving={saving*100:.1f}%)")
    shares = {n: v[0] for n, v in out.items()}
    mono = all(shares[a] >= shares[b] - 1e-4 for a, b in
               zip(SIZES[:-1], SIZES[1:]))
    print(f"#   overhead share monotonically falls with array size: "
          f"{'CONFIRMED' if mono else 'REFUTED'} "
          f"(paper: 5.7% area overhead at 16x16, shrinking with size)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(device=args.device)
