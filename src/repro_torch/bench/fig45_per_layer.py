"""Paper Figs. 4 & 5: per-layer power (conventional vs proposed SA) and
input-zero percentage, ResNet50 + MobileNetV1.

Claims C3 (29% avg streaming-activity reduction) and C4 (per-layer savings
band, correlated with zero fraction).

Run:  python -m repro_torch.bench.fig45_per_layer
      [--net resnet50|mobilenet|both] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from .common import analyze_cached, row


def run_net(net: str, device="cuda") -> None:
    data = analyze_cached(net, device=device)
    layers = data["layers"]
    print(f"# Fig.{'4' if net == 'resnet50' else '5'}: {net} per-layer "
          f"power (fJ/cycle) + zero%")
    print(f"# {'layer':10s} {'zero%':>6s} {'P_base':>9s} {'P_prop':>9s} "
          f"{'save%':>6s} {'act_red%':>8s}")
    for l in layers:
        print(f"# {l['name']:10s} {l['zero_fraction']*100:6.1f} "
              f"{l['power_base']:9.0f} {l['power_prop']:9.0f} "
              f"{l['saving_total']*100:6.1f} "
              f"{l['activity_reduction']*100:8.1f}")
    s = data["summary"]
    row(f"fig45_{net}_overall_power_reduction", 0.0,
        f"{s['overall_power_reduction']*100:.2f}%")
    row(f"fig45_{net}_mean_activity_reduction", 0.0,
        f"{s['mean_activity_reduction']*100:.2f}%")
    row(f"fig45_{net}_layer_saving_band", 0.0,
        f"{s['per_layer_saving_min']*100:.1f}%.."
        f"{s['per_layer_saving_max']*100:.1f}%")

    # C4: savings correlate with zero fraction (conv layers)
    zf = np.array([l["zero_fraction"] for l in layers])
    sv = np.array([l["saving_total"] for l in layers])
    r = float(np.corrcoef(zf, sv)[0, 1])
    row(f"fig45_{net}_zero_saving_correlation", 0.0, f"r={r:.3f}")
    print(f"#   C4 correlation(zero%, saving) = {r:.2f} "
          f"({'CONFIRMED' if r > 0.6 else 'WEAK'})")


def main(net: str = "both", device="cuda") -> None:
    nets = ["resnet50", "mobilenet"] if net == "both" else [net]
    for n in nets:
        run_net(n, device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="both",
                    choices=["resnet50", "mobilenet", "both"])
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(net=args.net, device=args.device)
