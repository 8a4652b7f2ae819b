"""Model-wide power tracing: every matmul a model runs, streamed through
the systolic-array model, energies summed over sites before any ratio is
taken (the paper's network-level method).

    from repro_torch import trace
    report = trace.trace_model(fn, *args, name="model")
    print(report.table())

Layers:
  interpret -- runs a callable and finds every matmul and convolution it
               executes, with its operands in ``[B, M, K] x [B, K, N]``
               form (the models' seams and a dispatch-mode catch-all).
  capture   -- the per-site registry with operand and call sampling; the
               serving engine books each retired request's counters here.
  report    -- per-site rows and model aggregates, JSON, CSV and a table.
  sweep     -- traces of the port's LM archs and CNNs across SA geometry
               and BIC segments.

``python -m repro_torch.trace`` runs traces from the command line.
"""
from __future__ import annotations

from typing import Callable, Sequence

from .capture import DEFAULT_CAPTURE, CaptureConfig, TraceCapture
from .interpret import MatmulSite, trace_fn
from .report import SitePower, TraceReport, build_report
from .sweep import run_sweep, trace_arch, trace_cnn  # noqa: F401

__all__ = [
    "CaptureConfig", "TraceCapture", "MatmulSite", "trace_fn",
    "SitePower", "TraceReport", "build_report",
    "trace_model", "trace_calls", "trace_arch", "trace_cnn", "run_sweep",
]


def trace_calls(fn: Callable, calls: Sequence[tuple], *,
                name: str = "model",
                cfg: CaptureConfig = DEFAULT_CAPTURE,
                capture: TraceCapture | None = None) -> TraceReport:
    """Trace ``fn(*args)`` for every args-tuple in ``calls``, accumulating
    per-site statistics across calls (decode steps, several batches)
    into ``capture`` (a new one of ``cfg`` by default)."""
    cap = capture or TraceCapture(cfg)
    cfg = cap.cfg
    skipped: list[str] = []
    for args in calls:
        _, sk = trace_fn(fn, *args, emit=cap,
                         include_conv=cfg.include_conv, name=name)
        skipped.extend(sk)
    return build_report(cap, name, tuple(dict.fromkeys(skipped)))


def trace_model(fn: Callable, *args, name: str = "model",
                cfg: CaptureConfig = DEFAULT_CAPTURE,
                capture: TraceCapture | None = None) -> TraceReport:
    """Trace one call of ``fn(*args)`` and report every matmul's BIC+ZVG
    power outcome; the function computes what it computes untraced."""
    return trace_calls(fn, [args], name=name, cfg=cfg, capture=capture)
