"""Read a cell's compared numbers on many seeds in one process: the
program's (sound runs) and, with ``--control 1``, the control's (the
reference one precision down in the program's place), to set a limit
from. Each seed is a whole run of the cell (set-up, a window of
``--seconds``, the checks); the set-up's imports and kernel loads are
paid once. Not one of the benchmark's runs.

    python3 perfbench/tools/readings.py --workload <cell> \\
        --seeds 11,12,13 --seconds 2 [--control 1]

Prints one JSON line a seed: ``seed``, ``correct``, ``checks``,
``control``, ``attempted``, ``wall_s``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from perfbench import run as bench_run
    bench_run._caches()
    import torch
    from perfbench.harness import core

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    bench = core.benchmark(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = core.run_cell(bench, args.workload, seed, args.seconds, False,
                            "cuda", control=bool(args.control))
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"],
                          "control": res.get("control"),
                          "wall_s": time.perf_counter() - t0}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
