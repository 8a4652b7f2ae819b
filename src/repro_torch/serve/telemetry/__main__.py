"""Telemetry CLI: run a scripted traffic scenario, or replay a dumped
retirement stream offline under different windowing / hysteresis knobs.

    # serve a scenario with telemetry on (on the card; --device cpu
    # runs the plain versions on the CPU), print the flip timeline
    python -m repro_torch.serve.telemetry --scenario shift

    # dump the raw retirement records for offline what-ifs
    python -m repro_torch.serve.telemetry --scenario shift \\
        --dump-records r.json

    # replay: re-window the identical counters, no model, no serving
    python -m repro_torch.serve.telemetry --replay r.json --window 2 \\
        --hysteresis 0.01 --json timeline.json --csv timeline.csv

Replays are exact: floats round-trip through JSON unchanged, so a replay
with the original knobs reproduces the original timeline bit for bit,
and knob sweeps (window, stride, hysteresis, min_dwell) re-select over
the true served counters without re-serving. The records files are the
JAX package's (``python -m repro.serve.telemetry``): either CLI replays
the other's dumps to the same table.
"""
from __future__ import annotations

import argparse

from repro_torch.design.point import resolve_designs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.telemetry",
        description="windowed telemetry scenarios and offline replay")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scenario", choices=(),  # filled below (lazy import)
                     help="serve a scripted traffic scenario")
    src.add_argument("--replay", metavar="RECORDS.json",
                     help="re-window a dumped retirement stream offline")
    p.add_argument("--paged", action="store_true",
                   help="serve the scenario on the paged engine")
    p.add_argument("--quick", action="store_true",
                   help="halve per-phase request counts")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device a scenario is served on (cuda by "
                        "default; cpu runs the plain versions)")
    p.add_argument("--window", type=int, default=None,
                   help="retirements per window (default: scenario's)")
    p.add_argument("--stride", type=int, default=None,
                   help="window stride (< window slides; default tumbling)")
    p.add_argument("--hysteresis", type=float, default=0.0,
                   help="relative margin a challenger must win by")
    p.add_argument("--min-dwell", type=int, default=1,
                   help="windows an incumbent holds before challengers")
    p.add_argument("--candidates", default="",
                   help="comma-separated design subset to select among")
    p.add_argument("--actuate", action="store_true",
                   help="close the loop: apply committed flips to the "
                        "engine's accountant mid-run (scenario runs; a "
                        "replay of actuated records reproduces the "
                        "actuated energy track from the dumped swap "
                        "epochs regardless of this flag)")
    p.add_argument("--json", metavar="PATH",
                   help="write the timeline JSON here")
    p.add_argument("--csv", metavar="PATH",
                   help="write the per-(window,site) timeline CSV here")
    p.add_argument("--dump-records", metavar="PATH",
                   help="write the raw retirement records here (scenario "
                        "runs only; replays already have them)")
    return p


def main(argv=None) -> int:
    from . import ServeTelemetry, TelemetryConfig, load_records
    from .scenarios import SCENARIOS, run_scenario

    parser = build_parser()
    for a in parser._actions:           # fill scenario choices lazily
        if a.dest == "scenario":
            a.choices = sorted(SCENARIOS)
    args = parser.parse_args(argv)
    candidates = tuple(c for c in args.candidates.split(",") if c)

    if args.replay:
        meta, records = load_records(args.replay)
        from repro_torch.core import monitor
        mcfg = monitor.MonitorConfig(
            designs=resolve_designs(meta["designs"]))
        tcfg = TelemetryConfig(
            window=args.window or 8, stride=args.stride,
            hysteresis=args.hysteresis, min_dwell=args.min_dwell,
            candidates=candidates)
        telem = ServeTelemetry(tcfg, mcfg)
        for rec in records:
            telem.on_retire(rec)
        timeline = telem.finalize()
        registry = telem.registry
        print(f"replayed {len(records)} retirements from {args.replay}")
    else:
        scenario = SCENARIOS[args.scenario]
        tcfg = TelemetryConfig(
            window=args.window or scenario.window, stride=args.stride,
            hysteresis=args.hysteresis, min_dwell=args.min_dwell,
            candidates=candidates, actuate=args.actuate)
        out = run_scenario(scenario, tcfg=tcfg, paged=args.paged,
                           quick=args.quick, seed=args.seed,
                           device=args.device)
        timeline = out["timeline"]
        registry = out["engine"].telemetry.registry
        print(f"scenario {scenario.name!r}: {scenario.description}")

    print(timeline.table())
    if args.dump_records:
        registry.dump_records(args.dump_records)
        print(f"records -> {args.dump_records}")
    if args.json:
        timeline.to_json(args.json)
        print(f"timeline -> {args.json}")
    if args.csv:
        timeline.to_csv(args.csv)
        print(f"timeline -> {args.csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
