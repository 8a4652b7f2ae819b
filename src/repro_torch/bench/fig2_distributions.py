"""Paper Fig. 2: value / exponent / mantissa distributions of CNN weights.

Claim C1: bf16 exponents of trained CNN weights are highly concentrated
(near the bias) while mantissas are near-uniform -- the statistical basis
for mantissa-only BIC. ``nets.init_weights`` makes the JAX package's
numpy draws, so the histograms are its counts.

Run:  python -m repro_torch.bench.fig2_distributions [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.apps.cnn import nets
from repro_torch.core import activity

from .common import row, timed


def all_weights(net: str, device="cuda") -> torch.Tensor:
    """Every weight of ``net`` flattened into one float32 vector, in the
    JAX benchmark's order."""
    ws = nets.init_weights(nets.NETS[net](), device=device)
    return torch.cat([w.reshape(-1) for w in ws.values()])


def stats(allw: torch.Tensor) -> dict:
    """The field histograms of ``allw`` and the three numbers of Fig. 2:
    the exponents' and the mantissas' concentrations and the share of
    weights in [-1, 1]."""
    h = activity.field_histograms(allw)
    return {
        "hist": h,
        "exp_conc": float(activity.concentration(h["exp_counts"])),
        "mant_conc": float(activity.concentration(h["mant_counts"])),
        "within_pm1": float(
            (allw.abs() <= 1.0).to(torch.float32).mean()),
    }


def run_net(net: str, device="cuda") -> dict:
    allw = all_weights(net, device)
    out, us = timed(lambda: stats(allw))
    row(f"fig2_{net}_exp_concentration", us, f"{out['exp_conc']:.3f}")
    row(f"fig2_{net}_mant_concentration", us, f"{out['mant_conc']:.3f}")
    row(f"fig2_{net}_weights_in_[-1,1]", us, f"{out['within_pm1']:.3f}")
    ok = out["exp_conc"] > 0.8 and out["mant_conc"] < 0.2
    print(f"#   {net}: exponents concentrated={out['exp_conc']:.2f}, "
          f"mantissa uniform={out['mant_conc']:.2f} -> C1 "
          f"{'CONFIRMED' if ok else 'REFUTED'}")
    return out


def main(device="cuda") -> None:
    print("# Fig.2: weight field distributions (concentration = mass in "
          "top-8 buckets)")
    for net in ("resnet50", "mobilenet"):
        run_net(net, device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(device=args.device)
