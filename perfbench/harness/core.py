"""One run of one cell: loading its files by name, the set-up clock, the
measured window, spans, the traced sub-window, the checks and the
result line.

A cell (``workloads/<name>.json``) names its configuration
(``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``); the configuration names the driver
(``drivers/<driver>.py``) that knows the system entry it exercises, and
its plain reference (``reference/<module>.py``, :func:`reference`). A
per-layer metric is ``metrics/<metric>.py`` with a ``read(run)`` (the
:class:`Run`) that returns a number or ``None`` when the run gave it
nothing to read.

A driver is a module with ``setup(run) -> state``, ``window(run,
state)``, ``end_to_end(run, state) -> {metric: value}`` and
``check(run, state) -> [Check]``; it calls :meth:`Run.unit` around each
unit of work (an analysis call, an engine step), which the traced run
uses to profile whole units.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path

import torch

from . import profile

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell ``name`` with its configuration and traffic files."""
    cell = load_json(bench_dir / "workloads" / f"{name}.json")
    return {"cell": cell,
            "config": load_json(bench_dir / "configs"
                                / f"{cell['config']}.json"),
            "traffic": load_json(bench_dir / "traffic"
                                 / f"{cell['traffic']}.json")}


def driver(config: dict, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "drivers" / f"{config['driver']}.py",
                       f"perfbench_driver_{config['driver']}")


def reference(config: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(f"perfbench.reference."
                                   f"{config['reference']}")


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "metrics" / f"{metric}.py",
                       "perfbench_metric_" + metric.replace(".", "_"))


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: its end-to-end ones
    (``trace`` off) or its per-layer ones (``trace`` on). A metric with a
    ``workloads`` list belongs to the cells listed; a per-layer metric
    without one belongs to every cell that reports the end-to-end metric
    it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def finite(v: float) -> float:
    """``v``, or the largest float for an infinite or NaN reading (the
    result line is JSON)."""
    v = float(v)
    return v if abs(v) <= 1.7976931348623157e308 else 1.7976931348623157e308


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit: the run
    is correct where every ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit

    def as_json(self) -> dict:
        return {"value": finite(self.value), "limit": self.limit}


class Run:
    """The state of one run that the driver and the readers share."""

    def __init__(self, *, name: str, files: dict, seed: int, seconds: float,
                 trace: bool, device: str, control: bool = False,
                 fault: str | None = None, t_start: float | None = None):
        self.name = name
        self.cell = files["cell"]
        self.config = files["config"]
        self.traffic = files["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        #: also read the control's numbers (the reference in the next
        #: lower precision in the program's place); never in the
        #: benchmark's own runs
        self.control = control
        #: a planted fault (the tests' and the control script's), or None
        self.fault = fault
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.spans: dict[str, list[float]] = {}
        self.counts: dict[str, float] = {}
        self.window_s = 0.0
        self.setup_s = 0.0
        self.memory_peak_bytes = 0
        self.profiled = None        # a profile.Summary after a traced run
        self.control_checks: list[Check] = []
        #: values noted while the profiler runs (per profiled unit)
        self.notes: dict[str, list] = {}
        #: host seconds the window spent stopping the profiler: not the
        #: program's, so the drivers leave them out of the window
        self.paused_s = 0.0
        self._units = 0
        self._profiler = None
        self._prof_t0 = 0.0
        self._prof = None

    # ------------------------------------------------------------ clocks
    def sync(self) -> None:
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Time a call into one layer on the host clock; in a traced run
        it is also a profiler range, and with ``sync`` the card is
        synchronized first and last so the span holds the device work it
        started (only in a traced run: the untraced run is left as the
        program runs)."""
        rf = contextlib.nullcontext()
        if self.trace:
            rf = torch.profiler.record_function(name)
            if sync:
                self.sync()
        t0 = time.perf_counter()
        with rf:
            yield
            if self.trace and sync:
                self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def add(self, key: str, value: float = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + value

    @property
    def profiling(self) -> bool:
        return self._profiler is not None

    def note(self, key: str, value) -> None:
        self.notes.setdefault(key, []).append(value)

    # ------------------------------------------------- traced sub-window
    @contextlib.contextmanager
    def unit(self):
        """One unit of work of the window. A traced run profiles units
        ``trace_skip .. trace_skip + trace_units - 1`` of the cell file,
        whole."""
        skip = int(self.cell.get("trace_skip", 0))
        n = int(self.cell.get("trace_units", 1))
        if self.trace and self._units == skip:
            self._start_profile()
        try:
            yield
        finally:
            self._units += 1
            if self._profiler is not None and self._units == skip + n:
                self._stop_profile(n)

    def _start_profile(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.sync()
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.__enter__()
        self._prof_t0 = time.perf_counter()

    def _stop_profile(self, units: int) -> None:
        self.sync()
        t0 = time.perf_counter()
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        self._prof = (prof, t0 - self._prof_t0, units)
        self.paused_s += time.perf_counter() - t0

    def elapsed(self, t0: float) -> float:
        """Seconds of the window since ``t0``, the profiler's stop left
        out."""
        return time.perf_counter() - t0 - self.paused_s

    def finish_profile(self) -> None:
        """Close a profile the window ended inside (fewer units than the
        cell asks for were run), and reduce it, after the window."""
        if self._profiler is not None:
            self._stop_profile(self._units - int(self.cell.get("trace_skip",
                                                               0)))
        if self._prof is not None:
            prof, wall, units = self._prof
            self._prof = None
            self.profiled = profile.summarize(prof, wall, units)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", *, control: bool = False,
             fault: str | None = None, t_start: float | None = None,
             files: dict | None = None) -> dict:
    """Run cell ``name`` once and return its result (the dict printed as
    the result line). ``files`` overrides the cell's files (the tests run
    the harness at a size the CPU holds)."""
    files = files or cell_files(name)
    run = Run(name=name, files=files, seed=seed, seconds=seconds,
              trace=trace, device=device, control=control, fault=fault,
              t_start=t_start)
    drv = driver(run.config)
    state = drv.setup(run)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - run.t_start
    run.spans.clear()          # set-up's warm-up calls are not the window's
    run.counts.clear()
    drv.window(run, state)
    run.finish_profile()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    e2e = drv.end_to_end(run, state)
    e2e["setup_s"] = run.setup_s
    checks = drv.check(run, state)
    return result(bench, run, e2e, checks)


def result(bench: dict, run: Run, e2e: dict, checks: list[Check]) -> dict:
    """The result line: the cell's end-to-end metrics (or, traced, its
    per-layer metrics that found something to read), the device, and
    every compared number beside its limit, last."""
    metrics = {}
    for m in metrics_of(bench, run.name, run.trace):
        if run.trace:
            value = reader(m["name"]).read(run)
        else:
            value = e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.startswith("cuda") else "cpu",
              "kind": device_name(run.device),
              "count": int(run.cell.get("chips", 1)),
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": all(c.ok for c in checks),
           "attempted": int(run.counts.get("attempted", 0)),
           "failed": int(run.counts.get("failed", 0)),
           "metrics": metrics, "device": device}
    if run.trace and run.profiled is not None:
        device["busy_s"] = run.profiled.busy_s
        device["window_s"] = run.profiled.window_s
        out["breakdown"] = run.profiled.breakdown()
    if run.control_checks:
        out["control"] = {c.name: c.as_json() for c in run.control_checks}
    out["checks"] = {c.name: c.as_json() for c in checks}
    return out


def device_name(device: str) -> str:
    if device.startswith("cuda"):
        return torch.cuda.get_device_name(0)
    return "cpu"
