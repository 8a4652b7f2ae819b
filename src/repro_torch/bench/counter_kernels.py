"""The fused counter kernel (K1) vs its plain version.

Times :func:`repro_torch.core.systolic.sa_design_report` -- the single
entry every monitoring path (monitor / trace / serve / design.evaluate)
funnels through -- under both counter backends across geometry x menu
size, on the same operands:

* ``ref``  -- the plain PyTorch version (``kernels/power_counters/
  ref.py``), on the same device;
* ``cuda`` -- the Hopper kernel: every counter of the whole menu in one
  launch per edge.

The acceptance row is ``counters_128x128_menu4``: the kernel must beat
the plain version on the 128x128 geometry with the 4-entry menu. With
``--device cpu`` only the plain version runs: the kernel needs the card.

Run:  python -m repro_torch.bench.counter_kernels [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import bic, systolic

from .common import row, timed

#: menu-size axis: cumulative slices of the named segment menu
MENUS: dict[int, tuple[tuple[int, ...], ...]] = {
    n: tuple(bic.NAMED_SEGMENTS.values())[:n] for n in (1, 2, 4)
}

GEOMS = {"16x16": systolic.PAPER_SA, "128x128": systolic.MXU_SA}


def _operands(m: int, k: int, n: int, zf: float = 0.5):
    """The JAX benchmark's operands (the same numpy draws), float32 on
    the CPU."""
    rng = np.random.default_rng(11)
    A = np.abs(rng.standard_normal((m, k))).astype(np.float32)
    A[rng.random(A.shape) < zf] = 0.0
    W = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(W)


def report(A, W, geom, menu, backend: str) -> dict:
    """Both edges fully tabulated for ``menu``."""
    return systolic.sa_design_report(
        A, W, geom, west_bic=menu, north_bic=menu, west_zvg=True,
        north_zvg=True, backend=backend)


def main(quick: bool = False, device="cuda") -> None:
    device = torch.device(device)
    on_card = device.type == "cuda"
    print("# fused counter kernel vs its plain version "
          "(sa_design_report wall-clock, both edges fully tabulated)")
    # operand size is NOT reduced in quick mode: at toy sizes both
    # backends finish in microseconds and the comparison is pure timer
    # noise -- quick mode trims the grid instead
    m, k, n = 512, 1024, 512
    iters = 3 if quick else 10
    A, W = (t.to(device) for t in _operands(m, k, n))
    card = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"# operands {m}x{k} @ {k}x{n}, bf16, zero-fraction ~0.5, "
          f"backend device = {card}")
    backends = ("ref", "cuda") if on_card else ("ref",)
    if not on_card:
        print("# --device cpu: the kernel column is skipped (the counter "
              "kernel needs the card); the plain version alone is timed")

    accept = None
    for gname, geom in GEOMS.items():
        if quick and gname != "128x128":
            continue
        for msize, menu in MENUS.items():
            if quick and msize not in (1, 4):
                continue
            us = {}
            for backend in backends:
                _, us[backend] = timed(
                    lambda b=backend: report(A, W, geom, menu, b),
                    iters=iters)
            name = f"counters_{gname}_menu{msize}"
            if not on_card:
                row(name, float("nan"),
                    f"ref={us['ref']:.0f}us kernel not run (needs the card)")
                continue
            speedup = us["ref"] / us["cuda"]
            row(name, us["cuda"],
                f"ref={us['ref']:.0f}us speedup={speedup:.2f}x")
            if gname == "128x128" and msize >= 4:
                accept = speedup
    if accept is not None:
        verdict = "CONFIRMED" if accept > 1.0 else "REFUTED"
        print(f"#   acceptance: the kernel beats the plain version at "
              f"128x128 with a 4-entry menu -> {verdict} "
              f"({accept:.2f}x)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="128x128 and menus 1 and 4 only (CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(quick=args.quick, device=args.device)
