"""PowerMonitor: model the streaming power of the matmuls a system runs.

Given the (activations, weights) actually flowing through a layer, the
monitor streams them through the systolic-array model and prices every
:class:`repro_torch.design.DesignPoint` of its config. The serving
engine's :class:`repro_torch.serve.power.PowerAccountant` and
:class:`repro_torch.trace.capture.TraceCapture` are sums of
:func:`stream_counters` outputs: flat scalar counters keyed
``e/<design>/<component>``, ``h/<design>``, ``v/<design>``, plus
``cycles`` and the non-additive ``zero_fraction``. Summing them over
calls, scaling by sampled fractions, and only then taking ratios is the
paper's energy-before-ratios aggregation done incrementally.

Large operands are sub-sampled along each axis (:func:`_subsample`);
switching activity is a per-stream mean, so uniform sampling is
unbiased, and :func:`sampled_fraction_scale` scales counters back to
the full extent.
"""
from __future__ import annotations

import dataclasses

import torch

from . import bic, power, systolic


def _evaluate_operands(A, W, designs, backend=None):
    """:func:`repro_torch.design.evaluate.evaluate_operands`, imported
    late: ``repro_torch.design`` imports this package's modules."""
    from repro_torch.design.evaluate import evaluate_operands
    return evaluate_operands(A, W, designs, backend)


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """What to stream, at which sampling caps, priced for which designs.

    ``designs`` is the explicit design list; empty (the default) means
    the paper pair built from ``geometry`` / ``bic_segments`` / ``zvg``
    and ``energy``. ``backend`` picks the counter pass (see
    :mod:`repro_torch.kernels.power_counters.ops`).
    """
    geometry: systolic.SAGeometry = systolic.PAPER_SA
    bic_segments: tuple[int, ...] = bic.MANTISSA_ONLY
    zvg: bool = True
    energy: power.EnergyModel = power.DEFAULT_ENERGY
    designs: tuple = ()
    backend: str | None = None
    max_rows: int = 256     # sample cap along M (input streams)
    max_cols: int = 256     # sample cap along N (weight streams)
    max_depth: int = 1024   # sample cap along K (stream length)

    @property
    def design_list(self) -> tuple:
        """The designs this monitor prices (the paper pair when unset)."""
        if self.designs:
            return self.designs
        from repro_torch.design.point import paper_pair
        return paper_pair(self.geometry, self.bic_segments, self.zvg,
                          self.energy)

    @property
    def design_names(self) -> tuple[str, ...]:
        return tuple(d.name for d in self.design_list)

    @property
    def reference_design(self) -> str:
        """Savings denominator: the first design in the list."""
        return self.design_list[0].name

    @property
    def primary_design(self) -> str:
        """Headline design: the second design (or the only one)."""
        names = self.design_names
        return names[1] if len(names) > 1 else names[0]


DEFAULT_MONITOR = MonitorConfig()

#: canonical per-design energy components in ``stream_counters`` keys
COMPONENTS = power.COMPONENTS + ("total",)


def subsample_index(n: int, cap: int) -> torch.Tensor:
    """The ``cap`` indices of an evenly strided sample spanning all of
    ``0..n-1``: ``floor(i * (n / cap))``, computed in float32 as the JAX
    package computes it (float64 picks other indices for some ``n``)."""
    step = torch.tensor(n / cap, dtype=torch.float32)
    return torch.floor(torch.arange(cap, dtype=torch.float32) * step).long()


def _subsample(x: torch.Tensor, cap: int, axis: int) -> torch.Tensor:
    """``cap`` evenly strided entries of ``x`` along ``axis``, reaching
    into the last ``n/cap``-sized bucket (so the tail of the axis is
    represented); ``x`` itself when ``n <= cap``."""
    n = x.shape[axis]
    if n <= cap:
        return x
    return x.index_select(axis, subsample_index(n, cap).to(x.device))


def subsample_operands(acts: torch.Tensor, weights: torch.Tensor,
                       cfg: MonitorConfig = DEFAULT_MONITOR):
    """``[..., K]`` activations as ``[M, K]``, and both operands capped at
    the config's sampling limits."""
    A = acts.reshape(-1, acts.shape[-1])
    A = _subsample(_subsample(A, cfg.max_rows, 0), cfg.max_depth, 1)
    W = _subsample(_subsample(weights, cfg.max_depth, 0), cfg.max_cols, 1)
    return A, W


def sample_sizes(acts_shape, weights_shape,
                 cfg: MonitorConfig = DEFAULT_MONITOR) -> dict:
    """Sampled and full sizes (host-side) for the given shapes."""
    m = 1
    for d in acts_shape[:-1]:
        m *= int(d)
    k, n = int(weights_shape[0]), int(weights_shape[1])
    return {
        "full_m": m, "full_k": k, "full_n": n,
        "sample_m": min(m, cfg.max_rows),
        "sample_k": min(k, cfg.max_depth),
        "sample_n": min(n, cfg.max_cols),
    }


def monitor_streams(A: torch.Tensor, W: torch.Tensor,
                    cfg: MonitorConfig = DEFAULT_MONITOR) -> dict:
    """The twin-design view of pre-shaped ``[M, K] x [K, N]`` operands
    (no reshaping or sub-sampling): the paper pair of the config's
    ``geometry`` / ``bic_segments`` / ``zvg``, priced with its
    ``energy``. Returns ``{"report": <sa_stream_report counters>,
    "power": <sa_power dict>}``, raw counters that aggregate across sites
    with :func:`repro_torch.core.power.aggregate_savings`. Refuses an
    explicit ``designs`` list: that goes through :func:`stream_counters`
    or :func:`repro_torch.design.evaluate_operands`."""
    if cfg.designs:
        raise ValueError(
            "monitor_streams is the legacy twin-design wrapper and cannot "
            "price an explicit MonitorConfig.designs list; use "
            "stream_counters (flat per-design counters) or "
            "repro_torch.design.evaluate_operands")
    rep = systolic.sa_stream_report(A, W, cfg.geometry,
                                    tuple(cfg.bic_segments), cfg.zvg,
                                    backend=cfg.backend)
    return {"report": rep, "power": power.sa_power(rep, cfg.energy)}


def stream_counters(A: torch.Tensor, W: torch.Tensor,
                    cfg: MonitorConfig = DEFAULT_MONITOR) -> dict:
    """Flat scalar counters (float32 0-d tensors) for one pre-shaped
    ``[M, K] x [K, N]`` stream, or ``[B]`` tensors for a batch ``[B, M,
    K] x [B, K, N]`` (one counter launch per edge for all of it): per
    design ``e/<d>/<component>`` energies (fJ) and ``h/<d>`` / ``v/<d>``
    pipeline toggles, plus ``cycles`` and ``zero_fraction``."""
    ev = _evaluate_operands(A, W, cfg.design_list, cfg.backend)
    return flatten_evaluated(ev, cfg.design_names)


def flatten_evaluated(ev: dict, design_names: tuple[str, ...]) -> dict:
    """An evaluation ``{design: {"energy", "h", "v", ...}}`` as the flat
    counter dict of :func:`stream_counters` (shared with the serving
    engine's decode assembler)."""
    flat = {}
    for name, r in ev.items():
        for comp, v in r["energy"].items():
            flat[f"e/{name}/{comp}"] = v
        flat[f"h/{name}"] = r["h"]
        flat[f"v/{name}"] = r["v"]
    first = ev[design_names[0]]
    flat["cycles"] = first["cycles"]
    flat["zero_fraction"] = first["zero_fraction"]
    return flat


def sampled_fraction_scale(m: int, k: int, n: int,
                           cfg: MonitorConfig = DEFAULT_MONITOR,
                           sampled_m: int | None = None) -> float:
    """Factor that scales counters of sub-sampled ``[ms, ks] x [ks, ns]``
    operands back to the full ``[m, k] x [k, n]`` extent (every counter
    grows about linearly in M, K and N, so ratios stay exact).
    ``sampled_m`` overrides the default ``min(m, max_rows)``."""
    ms = min(m, cfg.max_rows) if sampled_m is None else sampled_m
    ks = min(k, cfg.max_depth)
    ns = min(n, cfg.max_cols)
    return (m / ms) * (k / ks) * (n / ns)


def counters_to_energy(counters: dict, scale: float = 1.0) -> dict:
    """Accumulated flat counters as ``{design: {component: fJ}}``."""
    out: dict[str, dict[str, float]] = {}
    for key, v in counters.items():
        if key.startswith("e/"):
            _, name, comp = key.split("/", 2)
            out.setdefault(name, {})[comp] = float(v) * scale
    return out


def counters_toggles(counters: dict, scale: float = 1.0) -> dict:
    """Per-design ``{"h": ..., "v": ...}`` pipeline toggles from
    accumulated flat counters."""
    out: dict[str, dict[str, float]] = {}
    for key, v in counters.items():
        if key.startswith(("h/", "v/")):
            axis, name = key.split("/", 1)
            out.setdefault(name, {})[axis] = float(v) * scale
    return out


def monitor_matmul(acts: torch.Tensor, weights: torch.Tensor,
                   cfg: MonitorConfig = DEFAULT_MONITOR) -> dict:
    """Streaming-power metrics for one ``acts [..., K] @ weights [K, N]``
    matmul (leading dims of ``acts`` flattened into M), as float32 0-d
    tensors: zero fraction, streaming activity reduction, total and
    streaming savings and streaming share (primary design vs the
    reference design of ``cfg.design_list``), and the sample sizes
    actually streamed."""
    A, W = subsample_operands(acts, weights, cfg)
    ev = _evaluate_operands(A, W, cfg.design_list, cfg.backend)
    ref = ev[cfg.reference_design]
    pri = ev[cfg.primary_design]
    one = torch.tensor(1.0)
    metrics = {
        "zero_fraction": ref["zero_fraction"],
        "activity_reduction": 1.0 - (pri["h"] + pri["v"])
        / torch.maximum(ref["h"] + ref["v"], one),
        "saving_total": 1.0 - pri["energy"]["total"]
        / torch.maximum(ref["energy"]["total"], one),
        "saving_streaming": 1.0 - pri["energy"]["streaming"]
        / torch.maximum(ref["energy"]["streaming"], one),
        "streaming_share": ref["energy"]["streaming"]
        / ref["energy"]["total"],
    }
    metrics.update({k: torch.tensor(float(v))
                    for k, v in sample_sizes(acts.shape, weights.shape,
                                             cfg).items()})
    return metrics


#: size-metadata keys in monitor_matmul's output (not power metrics)
SIZE_KEYS = ("full_m", "full_k", "full_n", "sample_m", "sample_k",
             "sample_n")


def summarize(layer_metrics: dict[str, dict]) -> dict:
    """Mean metrics across monitored layers (for logging), as float32 0-d
    tensors keyed ``power/<metric>_mean``; the size metadata of
    :data:`SIZE_KEYS` is left out."""
    if not layer_metrics:
        return {}
    keys = next(iter(layer_metrics.values())).keys()
    return {f"power/{k}_mean": torch.stack(
                [torch.as_tensor(m[k], dtype=torch.float32)
                 for m in layer_metrics.values()]).mean()
            for k in keys if k not in SIZE_KEYS}
