"""The paper's CNN evaluation (Figs. 4/5 + the overall table) on ResNet50
or MobileNetV1, on the card.

Run:  PYTHONPATH=src python -m repro_torch.apps.cnn --net resnet50 --select

With ``--select`` every layer is priced for the whole named design menu
in the same stream pass and the cheapest design is chosen per layer.
``--device cpu`` runs it without a card (with the counters' plain
version); use a small ``--res`` there.
"""
from __future__ import annotations

import argparse

from repro_torch import design
from repro_torch.apps.cnn import analysis


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.apps.cnn")
    ap.add_argument("--net", default="resnet50",
                    choices=["resnet50", "mobilenet"])
    ap.add_argument("--images", type=int, default=1)
    ap.add_argument("--res", type=int, default=224,
                    help="input resolution in pixels (the paper's is 224)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--select", action="store_true",
                    help="price the full design menu per layer and pick "
                         "the cheapest design for each")
    args = ap.parse_args(argv)

    designs = (tuple(design.named_designs().values()) if args.select
               else ())
    print(f"analyzing {args.net} ({args.images} synthetic image(s) at "
          f"{args.res} px, 16x16 bf16 systolic array, on {args.device})...")
    layers = analysis.analyze_network(args.net, n_images=args.images,
                                      designs=designs, device=args.device,
                                      res=args.res)
    sel = analysis.select_network(layers) if args.select else None
    hdr = (f"{'layer':10s} {'zero%':>6s} {'P_base fJ/cyc':>13s} "
           f"{'P_prop fJ/cyc':>13s} {'saving':>7s}")
    if sel:
        hdr += f" {'best design':>12s} {'best%':>6s}"
    print(hdr)
    for l in layers:
        line = (f"{l.name:10s} {l.zero_fraction*100:6.1f} "
                f"{l.power_base:13.0f} {l.power_prop:13.0f} "
                f"{l.saving_total*100:6.1f}%")
        if sel:
            line += f" {l.selected:>12s} {l.saving(l.selected)*100:6.1f}%"
        print(line)
    s = analysis.network_summary(layers)
    print(f"\noverall dynamic power reduction: "
          f"{s['overall_power_reduction']*100:.1f}% "
          f"(paper: {'9.4' if args.net == 'resnet50' else '6.2'}%)")
    print(f"mean streaming-activity reduction: "
          f"{s['mean_activity_reduction']*100:.1f}% (paper avg: 29%)")
    if sel:
        ss = sel.summary()
        print(f"per-layer selection: {ss['saving_selected']*100:.2f}% vs "
              f"fixed proposed {ss['saving_fixed']*100:.2f}% "
              f"({ss['n_changed']}/{ss['n_sites']} layers prefer "
              f"{', '.join(ss['designs_used'])})")


if __name__ == "__main__":
    main()
