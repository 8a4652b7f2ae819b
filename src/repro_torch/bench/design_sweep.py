"""Design-space sweep benchmark: price the full autotuner grid and check
the pareto front against recorded goldens.

One cell, ``design_sweep``: trace the workloads once
(:func:`repro_torch.design.sweep.collect_sites`), then time the warm
pricing of the whole geometry x coding x precision x approx grid -- one
:func:`repro_torch.design.evaluate_batched` pass over every traced site
(the counter kernel, K1, once an edge a ``(geometry, precision)`` group
on the card). The derived column reports the grid size, the pricing
throughput, the pareto front, and how far widening the design space
beats the paper's fixed proposed design.

The run exits non-zero when the front regresses against the goldens,
the JAX package's floors (``benchmarks/design_sweep.py``), which hold
with slack under both ``--quick`` and the full grid:

* some non-square or sub-bf16 point beats the fixed proposed design on
  streaming energy by >= 30%;
* >= 100 such points beat it at all;
* the front holds an exact (accuracy-proxy 0) point saving >= 5% total
  energy and a sub-bf16 point saving >= 30%;
* the front stays small (2 to 24 points): a front spanning half the
  grid means domination collapsed.

Run:  python -m repro_torch.bench.design_sweep [--quick]
      [--emit-json BENCH_sweep.json] [--device cpu]
"""
from __future__ import annotations

from .common import benchmark_cli, emit_artifact, row, timed

#: regression floors of the pareto front (see the module doc)
GOLDENS = {
    "min_best_streaming_vs_fixed": 0.30,
    "min_beats_fixed": 100,
    "min_front": 2,
    "max_front": 24,
    "min_exact_front_saving": 0.05,
    "min_sub_bf16_saving": 0.30,
}


def best_vs_fixed(rep) -> float:
    """The largest streaming saving against the fixed design among the
    non-square or sub-bf16 points that beat it (0 when none does)."""
    beats = set(rep.beats_fixed)
    return max((r["streaming_vs_fixed"] for r in rep.rows
                if r["name"] in beats), default=0.0)


def check_goldens(rep) -> list[str]:
    """Golden checks on a :class:`repro_torch.design.sweep.SweepReport`;
    the list of failures (empty when the front is healthy)."""
    fails = []
    g = GOLDENS
    front = [rep.rows[i] for i in rep.front]
    if not (g["min_front"] <= len(front) <= g["max_front"]):
        fails.append(f"front size {len(front)} outside "
                     f"[{g['min_front']}, {g['max_front']}]")
    if len(rep.beats_fixed) < g["min_beats_fixed"]:
        fails.append(f"only {len(rep.beats_fixed)} non-square/sub-bf16 "
                     f"points beat the fixed design on streaming "
                     f"energy (golden >= {g['min_beats_fixed']})")
    best = best_vs_fixed(rep)
    if best < g["min_best_streaming_vs_fixed"]:
        fails.append(f"best streaming saving vs the fixed design "
                     f"{best * 100:.1f}% below golden "
                     f"{g['min_best_streaming_vs_fixed'] * 100:.0f}%")
    exact = [r for r in front if r["accuracy_proxy"] == 0.0]
    if not exact or max(r["saving_total"] for r in exact) \
            < g["min_exact_front_saving"]:
        fails.append("no exact (accuracy-proxy 0) front point saves "
                     f">= {g['min_exact_front_saving'] * 100:.0f}% "
                     "total energy")
    lossy = [r for r in front if r["precision"] != "bf16"]
    if not lossy or max(r["saving_total"] for r in lossy) \
            < g["min_sub_bf16_saving"]:
        fails.append("no sub-bf16 front point saves >= "
                     f"{g['min_sub_bf16_saving'] * 100:.0f}% total "
                     "energy")
    return fails


def main(quick: bool = False, emit_json: str | None = None,
         device="cuda") -> None:
    from repro_torch.design.sweep import (GEOMETRIES, QUICK_GEOMETRIES,
                                          build_sweep_report, collect_sites,
                                          sweep_grid)

    if quick:
        geoms, nets, archs, sample = (QUICK_GEOMETRIES, ("resnet50",), (),
                                      (64, 64, 64))
    else:
        geoms, nets, archs, sample = (GEOMETRIES, ("resnet50",),
                                      ("qwen1.5-0.5b",), (96, 96, 96))
    designs = sweep_grid(geometries=geoms)
    sites, trace_us = timed(
        lambda: collect_sites(nets=nets, archs=archs, res=64,
                              sample=sample, device=device),
        warmup=0, iters=1)
    rep, price_us = timed(
        lambda: build_sweep_report(sites, designs), warmup=1, iters=1)
    fails = check_goldens(rep)
    best = best_vs_fixed(rep)

    row("design_sweep", price_us,
        f"{len(designs)} points x {rep.n_sites} sites priced warm in "
        f"{price_us / 1e6:.1f}s "
        f"({len(designs) * rep.n_sites / (price_us / 1e6):.0f} "
        f"site-points/s) / front {len(rep.front)} / "
        f"{len(rep.beats_fixed)} beat fixed on streaming "
        f"(best {best * 100:.1f}%)"
        + (f" / GOLDEN FAIL x{len(fails)}" if fails else ""))
    print("# " + "\n# ".join(rep.table().splitlines()))

    if emit_json:
        emit_artifact(
            emit_json,
            {"design_sweep": {
                "n_points": len(designs),
                "n_sites": rep.n_sites,
                "sample": list(rep.sample),
                "trace_wall_s": trace_us / 1e6,
                "price_wall_s": price_us / 1e6,
                "reference": rep.reference,
                "fixed": rep.fixed,
                "front": [rep.rows[i] for i in rep.front],
                "beats_fixed_streaming": list(rep.beats_fixed),
                "best_streaming_vs_fixed": best,
                "golden_failures": fails,
                "rows": rep.rows,
            }},
            quick=quick, goldens=GOLDENS)

    if fails:
        raise SystemExit("design-sweep pareto front regressed vs "
                         "goldens:\n  - " + "\n  - ".join(fails))


if __name__ == "__main__":
    benchmark_cli(main)
