"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout (the port's sources under ``src/``). The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number compared with the
reference beside its limit, which also close standard error. Without a
card (or with fewer than the cell asks for) it exits 2 and prints no
result; it exits 3 and prints no result if JAX or the JAX package was
loaded. ``--control 1`` also reads the control (the reference in the
next lower precision in the program's place) on the same requests or
batch, under ``"control"``: the benchmark's own runs never ask for it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: modules whose presence in the process refuses the result: JAX and
#: the JAX package this port was made from (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc builds already go to ``build/kernels``)."""
    base = ROOT / "build" / "perfbench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the port (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    _caches()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import core

    bench = core.benchmark(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"perfbench: no cell {args.workload!r}; cells: "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = core.run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", control=bool(args.control),
                        t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 3
    checks = res["checks"]
    print(json.dumps(res), flush=True)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
