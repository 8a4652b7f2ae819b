"""What would BIC+ZVG save on a whole language model?

Traces a registry architecture end to end -- forward pass and/or decode
steps -- through the systolic-array power model, printing the per-layer
table (the paper's Fig. 4/5 method applied to an LM) and the
network-level aggregate. Decode steps accumulate per-site statistics
across steps, which is how serving-shaped workloads (1-token matmuls
against a mostly idle array) are costed. Runs on the card unless
``--device cpu``; the arch at its published widths unless ``--smoke``
(the JAX package's ``examples/trace_lm_power.py`` traces the smoke
config).

Run:  python -m repro_torch.apps.trace_lm_power [--arch qwen1.5-0.5b]
          [--mode both] [--json power.json] [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.trace import sweep as sw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.apps."
                                      "trace_lm_power")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--mode", default="both",
                    choices=["forward", "decode", "both"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--geometry", default="paper16",
                    choices=sorted(sw.GEOMETRIES))
    ap.add_argument("--segments", default="mantissa",
                    choices=sorted(sw.SEGMENTS))
    ap.add_argument("--json", default="",
                    help="write the (last) report to this JSON path")
    ap.add_argument("--smoke", action="store_true",
                    help="trace the arch's smoke config")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default; cpu runs "
                         "the plain versions)")
    args = ap.parse_args(argv)

    ccfg = sw.make_capture_config(args.geometry, args.segments)
    modes = ["forward", "decode"] if args.mode == "both" else [args.mode]
    rep = None
    for mode in modes:
        rep = sw.trace_arch(args.arch, mode, batch=args.batch,
                            seq=args.seq, decode_steps=args.decode_steps,
                            cfg=ccfg, smoke=args.smoke, device=args.device)
        print(rep.table())
        print()
    if args.json and rep is not None:
        rep.to_json(args.json)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
