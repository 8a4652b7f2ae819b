"""Run a cell traced, as ``run.py --trace 1`` does, with the port's span
recorder (``repro_torch.runtime.spans``) on, and put the profiled units'
device time and idle time down to the program span that caused them. Not
one of the benchmark's runs: its numbers are for ``PERF.md``.

    python3 perfbench/tools/spans.py --workload <cell> --seeds 11,12 \\
        --seconds 20 [--spans 0|1] [--check 0|1]

The run is ``harness/core.run_cell``'s own, with the cell's driver
wrapped to turn the recorder on over the window and read the engine's
``stats`` at its ends, and each unit of work timed. Prints one JSON line a
seed:

* ``metrics``: the cell's per-layer readers, as the traced run reports
  them, and ``end_to_end``;
* ``spans``: count, total and self ms by span over the window (only with
  ``--spans 1``; with ``--spans 0`` the program's spans are still profiler
  ranges, so the profiled units are split all the same);
* ``profiled``: the profiled units' ``device`` and ``idle`` seconds by
  innermost program span and by every span around them
  (``harness/attribution.py``), the kernels of each span, and how the
  kernels were tied to their launch calls;
* ``launches``: the profile's ``counters_kernel``, ``stream_kernel`` and
  ``walk_kernel`` launches beside the deltas of the port's
  ``launch_counts()`` over the same units;
* ``engine`` (serving cells): the engine's ``stats`` deltas over the
  window and over the profiled units, the harness's own ``prefill_tokens``,
  and each request's time to first token split by the engine's stamps:
  queue wait, its own admission, the hold until its step returned;
* ``would_read``: the per-layer quantities of ``harness/attribution.py``
  (``PERF.md`` §3 and §7), which a later benchmark change would read in
  the benchmark's own traced runs.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a.get(k, 0) for k in b
            if isinstance(b[k], (int, float))}


def _engine_stats(state) -> dict:
    eng = getattr(state, "eng", None)
    return dict(eng.stats) if eng is not None else {}


class _Driver:
    """The cell's driver, keeping its run and state, with the recorder on
    over the window and the engine's ``stats`` read at the window's ends.
    """

    def __init__(self, drv, spans_on: bool, check: bool):
        self.drv, self.spans_on, self.check_on = drv, spans_on, check

    def setup(self, run):
        self.run, self.state = run, self.drv.setup(run)
        return self.state

    def window(self, run, state) -> None:
        from repro_torch.runtime import spans

        if self.spans_on:
            spans.enable()
        self.s0 = _engine_stats(state)
        self.t0 = time.perf_counter_ns()
        self.drv.window(run, state)
        self.s1 = _engine_stats(state)
        self.records = spans.take()
        spans.disable()
        if run.at_start is not None and run.at_stop is None:
            run.at_stop = run.snapshot()     # the window ended mid-profile

    def end_to_end(self, run, state) -> dict:
        self.e2e = self.drv.end_to_end(run, state)
        return self.e2e

    def check(self, run, state) -> list:
        return self.drv.check(run, state) if self.check_on else []


def _traced(bench, cell: str, seed: int, seconds: float, drv: _Driver,
            device: str) -> tuple[dict, object]:
    """``core.run_cell``'s traced run of ``cell`` through ``drv``, with the
    raw profile kept and the port's launch counts and the engine's
    ``stats`` read where the profile starts and stops."""
    from perfbench.harness import core
    from repro_torch.kernels import launch_counts

    files = core.cell_files(cell)
    skip = int(files["cell"].get("trace_skip", 0))
    stop = skip + int(files["cell"].get("trace_units", 1))
    summarize = core.profile.summarize

    class SpanRun(core.Run):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.units_ns, self.raw = [], None
            self.at_start = self.at_stop = None

        def snapshot(self):
            return launch_counts(), _engine_stats(drv.state)

        @contextlib.contextmanager
        def unit(self):
            if len(self.units_ns) == skip:
                self.at_start = self.snapshot()
            t0 = time.perf_counter_ns()
            with super().unit():
                yield
            self.units_ns.append((t0, time.perf_counter_ns()))
            if len(self.units_ns) == stop:
                self.at_stop = self.snapshot()

    def keep(prof, wall, units):
        drv.run.raw = prof
        return summarize(prof, wall, units)

    with mock.patch.object(core, "Run", SpanRun), \
            mock.patch.object(core, "driver", lambda config, *a: drv), \
            mock.patch.object(core.profile, "summarize", keep):
        res = core.run_cell(bench, cell, seed, seconds, True, device,
                            files=files)
    return res, drv.run


def run_one(bench, cell: str, seed: int, seconds: float, spans_on: bool,
            check: bool, device: str = "cuda") -> dict:
    from perfbench.harness import attribution as at
    from perfbench.harness import core
    from repro_torch.runtime import spans

    drv = _Driver(core.driver(core.cell_files(cell)["config"]), spans_on,
                  check)
    res, run = _traced(bench, cell, seed, seconds, drv, device)
    state = drv.state
    out = {"cell": cell, "seed": seed, "spans_on": spans_on,
           "card": _card(), "metrics": res["metrics"],
           "end_to_end": drv.e2e, "device": res["device"],
           "breakdown": res.get("breakdown")}
    if check:
        out["correct"] = res["correct"]
        out["checks"] = res["checks"]
    t_end = int(getattr(state, "t_end", 0) * 1e9) or None
    window = [r for r in drv.records
              if r.start_ns >= drv.t0 and (t_end is None
                                           or r.start_ns <= t_end)]
    out["spans"] = spans.summary(_reindex(drv.records, window))
    would, prof_d = {}, {}
    if run.raw is not None:
        att = at.attribute(run.raw.events(), at.is_program)
        p = run.profiled
        out["profiled"] = dict(att, units=p.units, window_s=p.window_s,
                               busy_s=p.busy_s)
        dk = _delta(run.at_start[0], run.at_stop[0])
        out["launches"] = {
            "profile": {n: p.launches(n) for n in ("counters_kernel",
                                                   "stream_kernel",
                                                   "walk_kernel")},
            "program": dk,
            "agree": (p.launches("counters_kernel") == dk["k1"]
                      and p.launches("walk_kernel") == dk["k3"]
                      and p.launches("stream_kernel") == dk["k2"]
                      + dk["k3"])}
        prof_d = _delta(run.at_start[1], run.at_stop[1])
        would["device_named_share"] = at.named_share(att)
        if drv.s1:
            would["idle.serve.dispatch_ms"] = at.dispatch_idle_ms(att,
                                                                  p.units)
            would["serve.prefill_device_ms_per_1k_rows"] = (
                at.prefill_device_ms_per_1k_rows(att, prof_d))
        else:
            would["cnn.stream_prep_device_ms"] = at.stream_prep_device_ms(
                att, p.units)
    if drv.s1:
        sent = [r.req for r in state.recs.values() if r.in_window]
        dwin = _delta(drv.s0, drv.s1)
        would["serve.prefix_hit_share"] = at.prefix_hit_share(dwin)
        would["serve.queue_wait_p95_ms"] = at.queue_wait_p95_ms(sent)
        out["engine"] = {"stats_window": dwin, "stats_profiled": prof_d,
                         "harness_prefill_tokens":
                             run.counts.get("prefill_tokens", 0),
                         "ttft_split": _ttft_split(state)}
    else:
        would["cnn.price_host_ms"] = at.price_host_ms(window, run.units_ns)
    out["would_read"] = would
    return out


def _reindex(records, kept):
    """``kept`` (a subset of ``records`` in order) with its parent
    indices pointing into itself (-1 where the parent was left out)."""
    pos = {id(r): i for i, r in enumerate(kept)}
    index = {i: pos.get(id(r), -1) for i, r in enumerate(records)}
    return [r._replace(parent=index.get(r.parent, -1)) for r in kept]


def _ttft_split(state) -> dict:
    """Each window request's time to first token (the harness's: send to
    the end of the step that returned the token) split at the engine's
    stamps: before it reached the engine, queued, its own admission (page
    handling, prefill, first token, prompt accounting, as the host saw
    it), the hold until the step ended. Medians, p95 and mean of each, in
    ms."""
    from perfbench.harness import stats

    parts = {"submit": [], "queue": [], "admission": [], "hold": [],
             "ttft": []}
    for r in state.recs.values():
        q = r.req
        if not (r.in_window and r.times and q.t_first):
            continue
        sent, done = r.submit_t * 1e9, r.times[0] * 1e9
        parts["submit"].append((q.t_submit - sent) / 1e6)
        parts["queue"].append((q.t_admit - q.t_submit) / 1e6)
        parts["admission"].append((q.t_first - q.t_admit) / 1e6)
        parts["hold"].append((done - q.t_first) / 1e6)
        parts["ttft"].append((done - sent) / 1e6)
    return {k: {"n": len(v), "median": stats.median(v),
                "p95": stats.percentile(v, 95),
                "mean": sum(v) / len(v) if v else None}
            for k, v in parts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--check", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from perfbench import run as bench_run
    bench_run._caches()
    import torch
    from perfbench.harness import core

    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    bench = core.benchmark(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_one(bench, args.workload, seed, args.seconds,
                      bool(args.spans), bool(args.check))
        out["wall_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
