"""Paper §III.B: BIC segment choice, as a design-grid sweep.

Claim C2: mantissa-only BIC maximizes streaming-toggle savings per encoder
bit for CNN weight streams; exponent-segment BIC is non-beneficial.

Each (geometry x north-bus coding) cell is a
:class:`repro_torch.design.DesignPoint`; one ``evaluate_operands`` pass
per geometry (one counter-kernel launch per edge on the card) prices the
whole coding column from a single walk over the real ResNet50 weight
stream. The weight-bus effect is isolated as the vertical-pipeline
toggle saving vs the uncoded north bus.

Run:  python -m repro_torch.bench.bic_variants [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import design as D
from repro_torch.apps.cnn import nets
from repro_torch.core import bic, systolic
from repro_torch.trace.sweep import GEOMETRIES

from .common import row, timed

#: north-bus coding variants (name -> BIC segments; None = uncoded)
VARIANTS: dict[str, tuple[int, ...] | None] = {
    "none": None,
    "mantissa_only": bic.MANTISSA_ONLY,
    "exponent_only": bic.EXPONENT_ONLY,
    "full_bus": bic.FULL_BUS,
    "mant+exp_segmented": bic.MANT_EXP,
}

#: encoded bus bits per variant (for the per-encoder-bit efficiency)
WIDTHS = {"mantissa_only": 7, "exponent_only": 8, "full_bus": 16,
          "mant+exp_segmented": 15}


def _grid(geom: systolic.SAGeometry) -> tuple[D.DesignPoint, ...]:
    """One design per coding variant (west=ZVG throughout, like the
    proposed design) plus the fully uncoded baseline reference."""
    designs = [D.DesignPoint("baseline", geometry=geom)]
    for name, segs in VARIANTS.items():
        north = D.NONE if segs is None else D.BIC(segs)
        designs.append(D.DesignPoint(
            name.replace("_", "-").replace("+", "."),
            west=D.ZVG, north=north, geometry=geom))
    return tuple(designs)


def operands(quick: bool = False):
    """The JAX benchmark's operands as float32 CPU tensors: ``s3b1.c2``'s
    weights as streamed ``[K, N]`` (cut to ``[512, 64]`` under
    ``quick``) and a ReLU-sparse synthetic input stream ``[128, K]``."""
    ws = nets.init_weights(nets.resnet50_specs())
    w = ws["s3b1.c2"].reshape(-1, ws["s3b1.c2"].shape[-1])  # [K, N]
    if quick:
        w = w[:512, :64]
    K = w.shape[0]
    rng = np.random.default_rng(0)
    A = np.abs(rng.standard_normal((128, K))).astype(np.float32)
    A[rng.random(A.shape) < 0.55] = 0.0
    return torch.from_numpy(A), w.contiguous()


def main(quick: bool = False, device="cuda") -> dict:
    """Print the grid's rows and the C2 verdicts; returns each
    geometry's priced grid ``{geometry: {design: {"energy", "h",
    "v"}}}`` as floats."""
    print("# BIC variant grid (geometry x north-bus coding) on a real "
          "ResNet50 weight stream")
    A, W = (t.to(device) for t in operands(quick))

    geoms = {"paper16": GEOMETRIES["paper16"]} if quick else GEOMETRIES
    results: dict[tuple[str, str], dict] = {}
    grids = {}
    for gname, geom in geoms.items():
        designs = _grid(geom)

        def run(designs=designs):
            ev = D.evaluate_operands(A, W, designs)
            return {n: {k: float(r[k]) if k != "energy" else
                        {c: float(x) for c, x in r[k].items()}
                        for k in ("energy", "h", "v")} for n, r in ev.items()}

        ev, us = timed(run, iters=1)
        grids[gname] = ev
        # one timing row per geometry: the grid is priced by ONE
        # evaluate_operands pass, so per-variant timings don't exist
        row(f"bic_{gname}_grid_pass", us,
            f"{len(designs)} designs priced from one stream pass")
        v_none = ev["none"]["v"]
        e_base = ev["baseline"]["energy"]["total"]
        for name in VARIANTS:
            cell = name.replace("_", "-").replace("+", ".")
            v_save = 1.0 - ev[cell]["v"] / max(v_none, 1.0)
            t_save = 1.0 - ev[cell]["energy"]["total"] / e_base
            results[(gname, name)] = {"v_save": v_save, "t_save": t_save}
            row(f"bic_{gname}_{name}", 0.0,
                f"weight-bus-save={v_save*100:.2f}% "
                f"total-save={t_save*100:.2f}%")

    for gname in geoms:
        g = {n: results[(gname, n)] for n in VARIANTS}
        best = max((n for n in VARIANTS if n != "none"),
                   key=lambda n: g[n]["v_save"])
        mant_ok = (g["mantissa_only"]["v_save"] > 0
                   and g["exponent_only"]["v_save"]
                   <= g["mantissa_only"]["v_save"])
        print(f"#   [{gname}] best weight-bus variant: {best}; "
              f"mantissa-only beneficial and >= exponent variant -> C2 "
              f"{'CONFIRMED' if mant_ok else 'REFUTED'}")
        # per-encoder-bit efficiency (weight-bus savings / encoded bits)
        for name, width in WIDTHS.items():
            eff = g[name]["v_save"] / width
            print(f"#   [{gname}] {name}: saving per encoded bit = "
                  f"{eff*100:.3f}%")
    return grids


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="one geometry on a cut of the stream (CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(quick=args.quick, device=args.device)
