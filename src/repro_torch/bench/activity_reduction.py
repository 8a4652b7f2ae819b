"""Paper §I/§IV: average streaming switching-activity reduction (~29%) and
kernel-level throughput of the activity-counting path.

Also times the three stream kernels on the card -- the transition
counter (K5), the bus-invert encoder (K6) and the tile-gated matmul (K7)
-- against their plain PyTorch versions (``ref.py``) on the same
operands (host clock, synchronized; each ``*_ref_*`` row is the plain
version on the same device). With ``--device cpu`` the kernels' rows say
that they need the card: no plain version runs under a kernel's name.

Run:  python -m repro_torch.bench.activity_reduction [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import bits as B
from repro_torch.kernels.bic_encode import ops as bic_ops
from repro_torch.kernels.bic_encode.ref import bic_encode_ref
from repro_torch.kernels.transitions.ops import count_transitions
from repro_torch.kernels.transitions.ref import transitions_ref
from repro_torch.kernels.zvg_matmul.ops import zvg_matmul
from repro_torch.kernels.zvg_matmul.ref import zvg_matmul_ref

from .common import analyze_cached, row, timed


def claim_rows(device="cuda") -> None:
    """Claim C3 across both CNNs: the rows and the verdict."""
    reds = []
    for net in ("resnet50", "mobilenet"):
        s = analyze_cached(net, device=device)["summary"]
        reds.append(s["mean_activity_reduction"])
        row(f"activity_reduction_{net}", 0.0,
            f"{s['mean_activity_reduction']*100:.2f}%")
    avg = sum(reds) / len(reds)
    row("activity_reduction_avg", 0.0,
        f"{avg*100:.2f}% (paper: 29%)")
    print(f"#   C3: mean streaming-activity reduction {avg*100:.1f}% "
          f"vs paper 29% "
          f"({'CONFIRMED' if 0.18 <= avg <= 0.40 else 'OFF-BAND'})")


def kernel_rows(device="cuda") -> None:
    """Each stream kernel against its plain version, on the operands of
    the JAX benchmark (the same numpy draws)."""
    device = torch.device(device)
    on_card = device.type == "cuda"

    def kernel_row(name, fn, derived):
        if not on_card:
            row(name, float("nan"), "not run: the kernel needs the card "
                                    "(--device cpu)")
            return
        _, us = timed(fn)
        row(name, us, derived)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.integers(0, 1 << 16, (2048, 256), np.uint16)).to(device)
    _, us_ref = timed(lambda: transitions_ref(x))
    row("transitions_ref_jnp", us_ref, "oracle (plain PyTorch)")
    kernel_row("transitions_cuda",
               lambda: count_transitions(x, backend="cuda"), "kernel (K5)")

    w = torch.from_numpy(
        rng.integers(0, 1 << 16, (2048, 128), np.uint16)).to(device)
    _, us_ref = timed(lambda: bic_encode_ref(w, int(B.MANT_MASK))[0])
    row("bic_encode_ref_scan", us_ref, "oracle (sequential scan)")
    kernel_row("bic_encode_cuda",
               lambda: bic_ops.bic_encode(w, int(B.MANT_MASK),
                                          backend="cuda")[0],
               "kernel (K6, chunked walk)")

    a = rng.standard_normal((256, 512)).astype(np.float32)
    a[rng.random(a.shape) < 0.6] = 0.0
    b = rng.standard_normal((512, 256)).astype(np.float32)
    at = torch.from_numpy(a).to(device, torch.bfloat16)
    bt = torch.from_numpy(b).to(device, torch.bfloat16)
    _, us_ref = timed(lambda: zvg_matmul_ref(at, bt)[0])
    row("zvg_matmul_ref_jnp", us_ref, "oracle")
    kernel_row("zvg_matmul_cuda",
               lambda: zvg_matmul(at, bt, backend="cuda")[0],
               "kernel (K7, tile gating)")


def main(device="cuda") -> None:
    claim_rows(device)
    kernel_rows(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(device=args.device)
