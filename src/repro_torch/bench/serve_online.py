"""Online-selection benchmark: windowed telemetry under shifting traffic.

When the traffic mix shifts, how much does re-running the paper's
per-site design choice per window buy over the fixed proposed design,
and how close does the causal (hysteresis-damped) online track come to
the oracle-static choice in hindsight? Cells, one per scenario of
:data:`repro_torch.serve.telemetry.scenarios.SCENARIOS`:

* ``serve_online_<scenario>`` -- the scripted traffic served with
  telemetry on and the loop closed (``actuate=True``); the derived
  column reports windows, flips, swaps and the four savings tracks
  (fixed / online / oracle / actuated, energies before ratios).
  Actuation is pricing bookkeeping only (the served tokens and counters
  are the same with it on or off), so one actuated serve gives all four
  tracks; every scenario must land actuated >= fixed, or the closed loop
  stopped paying for itself.
* ``serve_online_overhead`` -- wall time of windowed selection against
  one window that never closes (registry only) on the shift scenario.

A run with no design flip anywhere fails: the scenarios are built so
the west bus's best coding flips between the sparse-band and dense-band
phases (bic-west <-> mant-exp).

``--emit-json BENCH_online.json`` writes every cell (with the flip list)
in the JAX benchmark's artifact shape, checked by
``schemas/bench_online.schema.json``.

Run:  python -m repro_torch.bench.serve_online [--quick]
      [--emit-json BENCH_online.json] [--device cpu]
"""
from __future__ import annotations

import time

from .common import _sync, benchmark_cli, emit_artifact, row


def main(quick: bool = False, emit_json: str | None = None,
         device="cuda") -> None:
    from repro_torch.serve.telemetry.registry import TelemetryConfig
    from repro_torch.serve.telemetry.scenarios import SCENARIOS, run_scenario

    def serve(scenario, tcfg):
        _sync()
        t0 = time.perf_counter()
        out = run_scenario(scenario, tcfg=tcfg, quick=quick, device=device)
        _sync()
        return out, time.perf_counter() - t0

    results: dict[str, dict] = {}
    total_flips = 0
    shift_wall = None
    for name, scenario in sorted(SCENARIOS.items()):
        out, dt = serve(scenario, TelemetryConfig(window=scenario.window,
                                                  actuate=True))
        eng, tl = out["engine"], out["timeline"]
        sm = tl.summary()
        total_flips += sm["n_flips"]
        if name == "shift":
            shift_wall = dt
        if sm["saving_actuated"] + 1e-12 < sm["saving_fixed"]:
            raise SystemExit(
                f"scenario {name!r}: actuated track "
                f"({sm['saving_actuated'] * 100:.3f}%) fell below the "
                f"fixed-primary track ({sm['saving_fixed'] * 100:.3f}%) "
                f"-- the closed loop is committing losing swaps")
        tok_s = eng.stats["tokens"] / dt
        row(f"serve_online_{name}",
            dt / max(eng.stats["decode_steps"], 1) * 1e6,
            f"{sm['n_windows']} windows / {sm['n_flips']} flips / "
            f"{sm['n_swaps']} swaps / "
            f"saving fixed {sm['saving_fixed'] * 100:.2f}% "
            f"online {sm['saving_online'] * 100:.2f}% "
            f"oracle {sm['saving_oracle'] * 100:.2f}% "
            f"actuated {sm['saving_actuated'] * 100:.2f}% "
            f"({tok_s:.0f} tok/s)")
        results[name] = {
            "description": scenario.description,
            "arch": scenario.arch,
            "tokens_per_s": tok_s,
            "wall_s": dt,
            **{k: sm[k] for k in ("n_windows", "n_requests", "n_flips",
                                  "n_swaps", "saving_fixed",
                                  "saving_online", "saving_oracle",
                                  "saving_actuated")},
            "oracle_choices": sm["oracle_choices"],
            "flips": [f.to_json_dict() for f in tl.flip_events],
            "swaps": [s.to_json_dict() for s in tl.swaps],
        }

    # telemetry overhead: the shift workload again (warm), windowed
    # selection against a single window that never closes -- the same
    # bookkeeping with no selection, so the difference is re-selection
    shift = SCENARIOS["shift"]
    _, dt_on = serve(shift, None)
    _, dt_huge = serve(shift, TelemetryConfig(window=10 ** 6))
    sel_cost = (dt_on - dt_huge) / max(dt_huge, 1e-9) * 100
    row("serve_online_overhead", dt_on * 1e6,
        f"windowed selection {sel_cost:+.0f}% wall vs registry-only "
        f"(first serve incl. warm-up {shift_wall:.1f}s)")
    results["overhead"] = {"wall_selection_s": dt_on,
                           "wall_registry_only_s": dt_huge,
                           "selection_cost_pct": sel_cost}

    if total_flips == 0:
        raise SystemExit(
            "no scenario produced a design flip: the telemetry stack no "
            "longer sees the traffic shift (expected bic-west <-> "
            "mant-exp flips on the sparse/dense phase boundary)")

    if emit_json:
        emit_artifact(emit_json, results, quick=quick,
                      scenarios=sorted(SCENARIOS))


if __name__ == "__main__":
    benchmark_cli(main)
