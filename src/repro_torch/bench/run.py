"""Benchmark suite entry point: one module per paper table/figure, plus
the serving-engine benchmarks. Prints ``name,us_per_call,derived`` CSV
rows interleaved with commentary lines (prefixed '#').

  python -m repro_torch.bench.run --all            # every suite, on the card
  python -m repro_torch.bench.run --only fig2_distributions --device cpu

Use ``--only <name> [...]`` for a subset, ``--list`` to enumerate,
``--quick`` to pass the smoke flag to the suites that support one, and
``--device cpu`` to run the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import traceback

from . import (activity_reduction, bic_variants, counter_kernels,
               design_sweep, fig2_distributions, fig45_per_layer,
               overall_savings, overhead_scaling, power_monitor_lm,
               serve_kernels, serve_online, serve_paging, serve_throughput,
               trace_full_model)

#: name -> (main fn, accepts quick=...). EVERY benchmark module must be
#: registered here -- tests/test_torch_bench_serve.py asserts the registry
#: matches the modules on disk (and the JAX package's registry), so
#: `--all` really runs everything.
SUITES = {
    "fig2_distributions": (fig2_distributions.main, False),
    "bic_variants": (bic_variants.main, True),
    "counter_kernels": (counter_kernels.main, True),
    "design_sweep": (design_sweep.main, True),
    "fig45_per_layer": (fig45_per_layer.main, False),
    "overall_savings": (overall_savings.main, False),
    "overhead_scaling": (overhead_scaling.main, False),
    "activity_reduction": (activity_reduction.main, False),
    "power_monitor_lm": (power_monitor_lm.main, False),
    "trace_full_model": (trace_full_model.main, True),
    "serve_kernels": (serve_kernels.main, True),
    "serve_online": (serve_online.main, True),
    "serve_paging": (serve_paging.main, True),
    "serve_throughput": (serve_throughput.main, True),
}


def run_suites(names: list[str], quick: bool = False,
               device="cuda") -> int:
    """Run the named suites on ``device``; returns the number of
    failures."""
    failures = 0
    print("name,us_per_call,derived")
    for name in names:
        fn, has_quick = SUITES[name]
        print(f"# ===== {name} =====")
        try:
            if has_quick:
                fn(quick=quick, device=device)
            else:
                fn(device=device)
        except Exception:                                # noqa: BLE001
            failures += 1
            print(f"# {name} FAILED:")
            traceback.print_exc()
    print("# roofline summary unavailable: it waits for the port of "
          "launch/roofline.py (ROADMAP queue 1 step 7)")
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="run every registered suite (default when no "
                         "--only is given)")
    ap.add_argument("--only", nargs="+", choices=sorted(SUITES),
                    metavar="NAME", help="run only these suites")
    ap.add_argument("--quick", action="store_true",
                    help="pass the smoke flag to suites that support one")
    ap.add_argument("--list", action="store_true",
                    help="list registered suites and exit")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default; cpu runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    if args.list:
        for name in SUITES:
            print(name)
        return 0
    names = args.only if args.only else list(SUITES)
    return run_suites(names, quick=args.quick, device=args.device)


if __name__ == "__main__":
    sys.exit(min(main(), 1))
