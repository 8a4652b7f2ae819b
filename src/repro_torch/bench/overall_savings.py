"""Paper §IV headline table: overall dynamic power reduction.

Claim C5: 9.4% (ResNet50) and 6.2% (MobileNet) overall. The energy model
is calibrated on the ResNet50 aggregate ONLY (``core/power.py``); the
MobileNet number is a held-out prediction.

Run:  python -m repro_torch.bench.overall_savings [--device cpu]
"""
from __future__ import annotations

import argparse

from .common import analyze_cached, row

PAPER = {"resnet50": 0.094, "mobilenet": 0.062}


def main(device="cuda") -> None:
    print("# Overall dynamic power reduction vs paper")
    print(f"# {'net':10s} {'ours':>7s} {'paper':>7s} {'abs err':>8s}")
    for net, target in PAPER.items():
        s = analyze_cached(net, device=device)["summary"]
        ours = s["overall_power_reduction"]
        err = abs(ours - target)
        print(f"# {net:10s} {ours*100:6.2f}% {target*100:6.2f}% "
              f"{err*100:7.2f}pt")
        role = "calibration-target" if net == "resnet50" else "prediction"
        row(f"overall_{net}", 0.0,
            f"ours={ours*100:.2f}% paper={target*100:.1f}% ({role})")
    r50 = analyze_cached("resnet50", device=device)["summary"][
        "overall_power_reduction"]
    mnet = analyze_cached("mobilenet", device=device)["summary"][
        "overall_power_reduction"]
    order_ok = r50 > mnet
    row("overall_ordering_resnet_gt_mobilenet", 0.0, str(order_ok))
    print(f"#   ordering ResNet50 > MobileNet: "
          f"{'CONFIRMED' if order_ok else 'REFUTED'} (paper: 9.4 > 6.2)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(device=args.device)
