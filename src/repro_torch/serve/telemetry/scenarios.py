"""Scenario drivers: synthetic traffic mixes that make the optimal
design flip (the JAX package's ``repro.serve.telemetry.scenarios``).

Each scenario is a sequence of :class:`TrafficPhase` s drawing prompts
from a different token band / length regime, served through an engine
with windowed telemetry on. The phases differ in the value statistics of
the operand streams the accountant watches -- which is what BIC and ZVG
savings depend on -- so per-window re-selection picks different designs
as the mix shifts.

A randomly initialized embedding table has no zero values, so activation
sparsity (the statistic ZVG lives on) would never move between phases.
``sparse_band`` models it: embedding rows of a token-id band are
sparsified to ``sparse_density`` zeros before serving, standing in for
the activation sparsity real checkpoints show on structured (code-like)
input. Traffic from the sparse band streams high-zero-fraction west
operands (mant-exp and ZVG-heavy designs win); traffic from the dense
band streams dense gaussian rows (bic-west wins).

The MoE scenario serves the ``phi3.5-moe`` smoke config: band-shifted
prompts move the router's expert distribution from phase to phase.

The requests and the sparsity mask are drawn with numpy exactly as the
JAX module draws them, so both packages serve the same traffic; the
weights are the port's own (``lm.init_model`` from a seeded generator)
unless the caller passes ``params`` (e.g. converted from the JAX
package).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import monitor
from repro_torch.design.point import resolve_designs

from .registry import TelemetryConfig

#: the design menu scenarios are priced for: the paper pair plus the two
#: designs ResNet50's selection splits between -- small real margins, so
#: hysteresis is exercised and the flips are physical
SCENARIO_DESIGNS = ("baseline", "proposed", "bic-west", "mant-exp")


@dataclasses.dataclass(frozen=True)
class TrafficPhase:
    """One traffic regime: prompts drawn from a token band."""
    name: str
    requests: int
    token_lo: int
    token_hi: int
    len_lo: int = 6
    len_hi: int = 16
    max_new: int = 4


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A scripted traffic shift over one architecture."""
    name: str
    arch: str
    phases: tuple[TrafficPhase, ...]
    sparse_band: tuple[int, int] = (0, 0)   # token-id band to sparsify
    sparse_density: float = 0.9             # fraction of features zeroed
    window: int = 4                         # default telemetry window
    cache_len: int = 48
    slots: int = 2
    description: str = ""


#: token-id bands for the smoke vocab (256): [0, 64) is the "code-like"
#: sparse band, the rest dense "chat" traffic
SCENARIOS: dict[str, Scenario] = {
    "shift": Scenario(
        name="shift", arch="qwen1.5-0.5b",
        phases=(
            TrafficPhase("code", 8, 0, 64),
            TrafficPhase("chat", 8, 64, 256),
        ),
        sparse_band=(0, 64),
        description="two-phase code->chat shift: sparse-band prompts "
                    "(mant-exp wins) hand over to dense prompts "
                    "(bic-west wins)"),
    "mix3": Scenario(
        name="mix3", arch="qwen1.5-0.5b",
        phases=(
            TrafficPhase("code", 6, 0, 64, len_lo=6, len_hi=14),
            TrafficPhase("chat", 6, 64, 256, len_lo=4, len_hi=10),
            TrafficPhase("long-context", 3, 64, 256,
                         len_lo=24, len_hi=40, max_new=2),
        ),
        sparse_band=(0, 64),
        window=3,
        description="code -> chat -> long-context: the third phase "
                    "shifts energy share toward prefill sites (long "
                    "prompts, short decodes)"),
    "moe-drift": Scenario(
        name="moe-drift", arch="phi3.5-moe-42b-a6.6b",
        phases=(
            TrafficPhase("expert-band-a", 6, 0, 64, len_lo=4, len_hi=10),
            TrafficPhase("expert-band-b", 6, 128, 256,
                         len_lo=4, len_hi=10),
        ),
        sparse_band=(0, 64),
        window=3,
        description="expert-routing drift on the phi3.5-moe smoke "
                    "config: band-shifted prompts move the router's "
                    "expert distribution between phases"),
}


def scenario_monitor(backend: str | None = None) -> monitor.MonitorConfig:
    """The monitor config scenarios are priced under (one geometry, so
    the accountant's fused decode counters apply)."""
    return monitor.MonitorConfig(
        designs=resolve_designs(SCENARIO_DESIGNS), backend=backend)


def sparsify_embeddings(params: dict, band: tuple[int, int],
                        density: float, seed: int = 1) -> None:
    """Zero ``density`` of the embedding features of the token ids in
    ``[band[0], band[1])``, in place, by the JAX module's numpy mask.
    Models the activation sparsity of structured traffic on a randomly
    initialized model."""
    lo, hi = band
    if hi <= lo:
        return
    emb = params["embed"]
    rng = np.random.default_rng(seed)
    mask = rng.random((hi - lo,) + tuple(emb.shape[1:])) < density
    rows = emb[lo:hi]
    emb[lo:hi] = torch.where(torch.from_numpy(mask).to(emb.device),
                             torch.zeros_like(rows), rows)


def scenario_requests(scenario: Scenario, seed: int = 0,
                      quick: bool = False) -> list[tuple[str, list[int],
                                                         int]]:
    """The request stream: ``(phase name, prompt, max_new)`` per request,
    phases in order, all greedy."""
    rng = np.random.default_rng(seed)
    out = []
    for ph in scenario.phases:
        n = max(ph.requests // 2, 2) if quick else ph.requests
        for _ in range(n):
            length = int(rng.integers(ph.len_lo, ph.len_hi))
            prompt = list(map(int, rng.integers(ph.token_lo, ph.token_hi,
                                                length)))
            out.append((ph.name, prompt, ph.max_new))
    return out


def run_scenario(scenario: Scenario | str, *,
                 tcfg: TelemetryConfig | None = None,
                 paged: bool = False, quick: bool = False,
                 seed: int = 0, backend: str | None = None,
                 kernel_backend: str = "auto", device: str = "cuda",
                 params: dict | None = None) -> dict:
    """Serve a scenario end to end with telemetry on, on ``device``;
    returns ``{"engine", "finished", "report", "timeline"}`` where
    ``report`` is ``engine.telemetry_report()`` (registry flushed, oracle
    filled). ``backend`` is the monitor's counter backend,
    ``kernel_backend`` the engine's (:class:`repro_torch.serve.
    ServeConfig`). The weights are ``params`` if given (sparsified in
    place), else ``lm.init_model`` from a generator seeded 0 on the CPU,
    the same on every device."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import lm
    from repro_torch.serve import PagingConfig, ServeConfig, ServeEngine

    if isinstance(scenario, str):
        if scenario not in SCENARIOS:
            raise KeyError(f"unknown scenario {scenario!r}; have "
                           f"{sorted(SCENARIOS)}")
        scenario = SCENARIOS[scenario]
    cfg = SMOKES[scenario.arch].with_(compute_dtype="float32")
    if params is None:
        params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    sparsify_embeddings(params, scenario.sparse_band,
                        scenario.sparse_density)
    if tcfg is None:
        tcfg = TelemetryConfig(window=scenario.window)
    paging = (PagingConfig(page_size=8,
                           num_pages=scenario.slots * scenario.cache_len
                           // 8 + 1,
                           max_rows=scenario.slots * 2)
              if paged else None)
    scfg = ServeConfig(max_slots=scenario.slots,
                       cache_len=scenario.cache_len,
                       power_monitor=True, monitor=scenario_monitor(backend),
                       telemetry=tcfg, paging=paging,
                       kernel_backend=kernel_backend, device=device)
    engine = ServeEngine(params, cfg, scfg)
    for _, prompt, max_new in scenario_requests(scenario, seed=seed,
                                                quick=quick):
        engine.submit(prompt, max_new_tokens=max_new)
    finished = engine.run()
    report = engine.telemetry_report()
    return {"engine": engine, "finished": finished, "report": report,
            "timeline": engine.telemetry.selector.timeline}
