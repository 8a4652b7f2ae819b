"""Named-site capture: accumulate streaming-power counters per matmul
site.

A :class:`TraceCapture` keeps one :class:`SiteStats` per site name. Used
as the tracer's ``emit`` (:func:`repro_torch.trace.interpret.trace_fn`),
:meth:`TraceCapture.record` streams each :class:`MatmulSite`'s operands;
:meth:`TraceCapture.record_counters` books counters a caller already
holds (the serving engine, per retired request). Per call at most
``max_batch`` batch elements and the monitor's row/col/depth caps are
streamed, scaled back to the full extent; after ``max_calls_per_site``
sampled calls a site only counts invocations and its energies
extrapolate by ``calls / sampled_calls``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import monitor

from .interpret import MatmulSite  # noqa: F401  (its home before)


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    monitor: monitor.MonitorConfig = monitor.DEFAULT_MONITOR
    max_batch: int = 4            # batch elements streamed per call
    max_calls_per_site: int = 4   # calls fully sampled per site
    include_conv: bool = True     # trace convolutions too


DEFAULT_CAPTURE = CaptureConfig()


class SiteStats:
    """Mutable accumulator for one named matmul site."""

    def __init__(self, name: str, kind: str,
                 shape: tuple[int, int, int, int]):
        self.name = name
        self.kind = kind
        self.shape = shape            # (B, M, K, N) of the FIRST call
        self.calls = 0
        self.sampled_calls = 0
        self.macs = 0.0               # across ALL calls
        self.counters: dict[str, float] = {}
        self.zf_sum = 0.0

    def add(self, scaled: dict[str, float], zero_fraction: float):
        self.sampled_calls += 1
        self.zf_sum += zero_fraction
        for k, v in scaled.items():
            self.counters[k] = self.counters.get(k, 0.0) + v


class TraceCapture:
    """Site registry; an instance is the tracer's ``emit``."""

    def __init__(self, cfg: CaptureConfig = DEFAULT_CAPTURE):
        self.cfg = cfg
        self.sites: dict[str, SiteStats] = {}

    def __call__(self, site: MatmulSite):
        self.record(site)

    def _site(self, name: str, kind: str, shape) -> SiteStats:
        acc = self.sites.get(name)
        if acc is None:
            acc = self.sites[name] = SiteStats(name, kind, shape)
        return acc

    def record(self, site: MatmulSite):
        """Stream one call of a site (sampled as the module doc says)."""
        b, m, k, n = site.shape
        if min(b, m, k, n) == 0:
            return
        acc = self._site(site.name, site.kind, site.shape)
        acc.calls += 1
        acc.macs += site.macs
        if acc.sampled_calls >= self.cfg.max_calls_per_site:
            return
        mcfg = self.cfg.monitor
        # the sampled batch, each problem sub-sampled as the monitor does,
        # streamed in one pass (one counter launch an edge); the counters
        # arrive on the host as [bs] float32 tensors
        A3 = monitor._subsample(site.lhs, self.cfg.max_batch, 0)
        W3 = monitor._subsample(site.rhs, self.cfg.max_batch, 0)
        A3 = monitor._subsample(monitor._subsample(A3, mcfg.max_rows, 1),
                                mcfg.max_depth, 2)
        W3 = monitor._subsample(monitor._subsample(W3, mcfg.max_depth, 1),
                                mcfg.max_cols, 2)
        bs = A3.shape[0]
        per = {key: torch.broadcast_to(torch.as_tensor(v), (bs,))
               for key, v in monitor.stream_counters(A3, W3, mcfg).items()}
        zf = float(per.pop("zero_fraction").mean())
        keys = list(per)
        sums = torch.stack([per[key].sum() for key in keys]).tolist()
        factor = (b / bs) * monitor.sampled_fraction_scale(m, k, n, mcfg)
        acc.add({key: v * factor for key, v in zip(keys, sums)}, zf)

    def record_counters(self, name: str, kind: str,
                        shape: tuple[int, int, int, int],
                        counters: dict, macs: float | None = None):
        """Book one call's flat counters, already scaled to the full
        operand extent, into a named site; ``zero_fraction`` may be
        present and is averaged."""
        b, m, k, n = shape
        acc = self._site(name, kind, shape)
        acc.calls += 1
        acc.macs += float(b) * m * k * n if macs is None else macs
        counters = dict(counters)
        zf = float(counters.pop("zero_fraction", 0.0))
        acc.add({key: float(v) for key, v in counters.items()}, zf)

    # -------------------------------------------------------------- views
    def site_energy(self, acc: SiteStats) -> dict:
        """Per-site ``{design: {component: fJ}}`` energies, extrapolated
        over unsampled calls."""
        scale = acc.calls / max(acc.sampled_calls, 1)
        return monitor.counters_to_energy(acc.counters, scale)

    def site_toggles(self, acc: SiteStats) -> dict:
        """Per-site ``{design: {"h": ..., "v": ...}}`` pipeline toggles,
        extrapolated like :meth:`site_energy`."""
        scale = acc.calls / max(acc.sampled_calls, 1)
        return monitor.counters_toggles(acc.counters, scale)
