"""CLI: model-wide BIC+ZVG power tracing with the port.

Traces the port's LM archs and CNNs end to end and prints per-site tables
and the network-level aggregate; ``--json``/``--csv`` export the reports.
Runs on the card unless ``--device cpu``.

    python -m repro_torch.trace --device cpu --res 32
    python -m repro_torch.trace --archs qwen1.5-0.5b --nets '' --mode decode
    python -m repro_torch.trace --sweep --segments mantissa,full
    python -m repro_torch.trace --nets resnet50 --archs '' --select

``--designs`` prices an explicit :mod:`repro_torch.design` list instead
of the baseline/proposed pair; ``--select`` adds per-site greedy selection
over those designs (the full named menu by default) and reports the
``selected`` pseudo-design. Archs are traced at their smoke configs, as
the JAX CLI traces them.
"""
from __future__ import annotations

import argparse
import os

from repro_torch import design
from repro_torch.kernels.power_counters.ops import BACKENDS

from . import sweep as sw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description="Trace every matmul of whole models through the "
                    "systolic-array BIC+ZVG power model.")
    ap.add_argument("--archs", default="qwen1.5-0.5b",
                    help="comma-separated registry architectures "
                         "('' for none)")
    ap.add_argument("--nets", default="resnet50",
                    help="comma-separated CNNs ('' for none)")
    ap.add_argument("--mode", default="forward",
                    choices=["forward", "decode"])
    ap.add_argument("--geometry", default="paper16",
                    help=f"named preset ({sorted(sw.GEOMETRIES)}) or a "
                         f"free-form RxC spec like 8x32")
    ap.add_argument("--segments", default="mantissa",
                    help="BIC segment choice(s), comma-separated "
                         f"(from {sorted(sw.SEGMENTS)})")
    ap.add_argument("--designs", default="",
                    help="comma-separated design names to price per site "
                         f"(from {sorted(design.named_designs())}); "
                         "overrides --segments")
    ap.add_argument("--select", action="store_true",
                    help="per-site greedy design selection over the "
                         "--designs list (the full named menu when "
                         "--designs is not given)")
    ap.add_argument("--backend", default="auto", choices=BACKENDS,
                    help="counter pass and decode matmuls: the Hopper "
                         "kernels on the card (auto, cuda) or the plain "
                         "versions (ref); bit-identical counters")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default; cpu runs "
                         "the plain versions)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--res", type=int, default=112,
                    help="CNN input resolution")
    ap.add_argument("--json", default="",
                    help="directory to write per-model JSON reports")
    ap.add_argument("--csv", default="",
                    help="directory to write per-model CSV reports")
    ap.add_argument("--sweep", action="store_true",
                    help="run the geometry x segments sweep and print the "
                         "summary grid")
    args = ap.parse_args(argv)

    archs = tuple(a for a in args.archs.split(",") if a)
    nets = tuple(n for n in args.nets.split(",") if n)
    try:
        sw.parse_geometry(args.geometry)
    except ValueError as e:
        ap.error(str(e))
    segments = tuple(s for s in args.segments.split(",") if s)
    bad = [s for s in segments if s not in sw.SEGMENTS]
    if bad or not segments:
        ap.error(f"unknown --segments {bad or ['(empty)']}; "
                 f"choose from {sorted(sw.SEGMENTS)}")
    designs = tuple(d for d in args.designs.split(",") if d)
    if args.select and not designs:
        designs = tuple(design.named_designs())
    if designs:
        menu = design.named_designs()
        bad = [d for d in designs if d not in menu]
        if bad:
            ap.error(f"unknown --designs {bad}; choose from {sorted(menu)}")
        if args.select and len(designs) < 2:
            ap.error("--select needs at least two --designs to choose "
                     "between")
    if args.sweep and designs:
        ap.error("--sweep sweeps geometry x segments; it does not compose "
                 "with --designs/--select")
    run = dict(device=args.device, backend=args.backend)

    def show(rep):
        if args.select:
            sel = design.apply_selection(rep)
            print(rep.table())
            s = sel.summary()
            print(f"selected: {s['saving_selected']*100:.2f}% total "
                  f"saving vs fixed {sel.primary} "
                  f"{s['saving_fixed']*100:.2f}% | {s['n_changed']}/"
                  f"{s['n_sites']} sites prefer a different design "
                  f"({', '.join(s['designs_used'])})")
        else:
            print(rep.table())
        print()

    if args.sweep:
        cells = sw.run_sweep(archs=archs, nets=nets,
                             geometries=tuple(sorted(sw.GEOMETRIES)),
                             segments=segments, mode=args.mode,
                             batch=args.batch, seq=args.seq, res=args.res,
                             **run)
        print(sw.format_sweep(cells))
        reports = [(c.model, c.geometry, c.segments, c.report)
                   for c in cells]
    else:
        ccfg = sw.make_capture_config(args.geometry, segments[0],
                                      designs=designs, backend=args.backend)
        # export tag: what was priced (a design list, or the segments)
        seg_tag = f"{len(designs)}designs" if designs else segments[0]
        reports = []
        for arch in archs:
            rep = sw.trace_arch(arch, args.mode, batch=args.batch,
                                seq=args.seq, cfg=ccfg, **run)
            show(rep)
            reports.append((arch, args.geometry, seg_tag, rep))
        for net in nets:
            rep = sw.trace_cnn(net, res=args.res, cfg=ccfg, **run)
            show(rep)
            reports.append((net, args.geometry, seg_tag, rep))

    for model, geom, seg, rep in reports:
        tag = f"{model.replace('/', '_')}_{geom}_{seg.replace('+', '')}"
        if args.json:
            os.makedirs(args.json, exist_ok=True)
            path = os.path.join(args.json, f"trace_{tag}.json")
            rep.to_json(path)
            print(f"wrote {path}")
        if args.csv:
            os.makedirs(args.csv, exist_ok=True)
            path = os.path.join(args.csv, f"trace_{tag}.csv")
            rep.to_csv(path)
            print(f"wrote {path}")


if __name__ == "__main__":
    main()
