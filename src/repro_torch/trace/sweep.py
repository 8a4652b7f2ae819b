"""Trace drivers and sweeps: the port's LM archs and CNNs, across SA
geometry and BIC segments.

The paper's per-layer method (per-layer zero fraction, activity
reduction, power saving; network savings with energies summed first)
applied to whole forward and decode executions: :func:`trace_arch` for a
registry architecture, :func:`trace_cnn` for ResNet50 / MobileNetV1,
:func:`run_sweep` over (model x geometry x segments) cells. Every entry
runs on the card unless ``device`` says otherwise; ``backend`` picks the
counter pass and the decode matmuls (the kernels on the card under
``"auto"``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bic, monitor, systolic
from repro_torch.design import resolve_designs

from .capture import CaptureConfig, TraceCapture
from .interpret import trace_fn
from .report import TraceReport, build_report

GEOMETRIES: dict[str, systolic.SAGeometry] = {
    "paper16": systolic.PAPER_SA,
    "mxu128": systolic.MXU_SA,
}


def parse_geometry(name: str) -> systolic.SAGeometry:
    """A named preset (``paper16``, ``mxu128``) or an ``RxC`` spec
    (``8x32``); bad specs raise ValueError naming the accepted forms."""
    if name in GEOMETRIES:
        return GEOMETRIES[name]
    parts = name.lower().split("x")
    if len(parts) == 2:
        try:
            return systolic.SAGeometry(int(parts[0]), int(parts[1]))
        except ValueError as e:   # non-int parts or rows/cols < 1
            raise ValueError(f"bad geometry {name!r}: {e}") from None
    raise ValueError(f"unknown geometry {name!r}: use one of "
                     f"{sorted(GEOMETRIES)} or an RxC spec like '8x32'")


#: alias of the canonical registry in :mod:`repro_torch.core.bic`
SEGMENTS = bic.NAMED_SEGMENTS


def make_capture_config(geometry: str = "paper16",
                        segments: str = "mantissa",
                        max_batch: int = 4,
                        max_calls_per_site: int = 4,
                        designs: tuple[str, ...] = (),
                        backend: str | None = None) -> CaptureConfig:
    """CaptureConfig from sweep-axis names: ``designs`` (names of
    :func:`repro_torch.design.named_designs`) prices that list on
    ``geometry``, else the paper pair of ``segments``; ``backend`` picks
    the counter pass (bit-identical either way)."""
    geom = parse_geometry(geometry)
    mcfg = monitor.MonitorConfig(
        geometry=geom, bic_segments=SEGMENTS[segments],
        designs=resolve_designs(designs, geom) if designs else (),
        backend=backend)
    return CaptureConfig(monitor=mcfg, max_batch=max_batch,
                         max_calls_per_site=max_calls_per_site)


# ------------------------------------------------------------ model inputs
def _zipf(vocab: int) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    return p / p.sum()


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t.long() if t.dtype == torch.int32 else t


def model_inputs(cfg, batch: int = 2, seq: int = 16, seed: int = 0,
                 device="cpu") -> dict:
    """A deterministic training-style batch for any registry config, as
    tensors: the JAX package's synthetic LM batch rule
    (``repro.data.pipeline.SyntheticLM``, one host, step 0), numpy only,
    from ``default_rng(seed * 1_000_003 * 997)``, so the same values as
    its. Zipf(1.1) tokens with the first half of each row copied into the
    second (``{"tokens"}``); for codes ``{"codes": [batch, K, seq]}`` of
    Zipf codes; for embeds the tokens as ``"labels"``, then ``"embeds"``
    (float32 normal draws times 0.02) and ``"positions"`` ``[3, batch,
    seq]``, every stream ``0..seq-1``. Ids and positions are int64."""
    rng = np.random.default_rng(seed * 1_000_003 * 997)
    if cfg.inputs == "codes":
        codes = rng.choice(cfg.vocab, size=(batch, cfg.codebooks, seq),
                           p=_zipf(cfg.vocab))
        return {"codes": _tensor(codes, device)}
    toks = rng.choice(cfg.vocab, size=(batch, seq), p=_zipf(cfg.vocab))
    half = seq // 2
    toks[:, half:half * 2] = toks[:, :half]
    out = {"tokens": toks}
    if cfg.inputs == "embeds":
        emb = rng.standard_normal((batch, seq, cfg.d_model)).astype(
            np.float32)
        out = {"embeds": emb * 0.02,
               "positions": np.broadcast_to(np.arange(seq), (3, batch, seq)),
               "labels": toks}
    return {k: _tensor(v, device) for k, v in out.items()}


def decode_inputs(cfg, batch: int, pos: int, seed: int = 0,
                  device="cpu") -> dict:
    """One-step decode inputs at position ``pos``, the JAX package's
    draws from ``default_rng(seed + pos)``: ``{"tokens" [batch, 1]}``,
    ``{"codes" [batch, K, 1]}`` or ``{"embeds" [batch, 1, D]}`` (normal
    draws times 0.02, rounded to bfloat16), with ``"positions"`` (``[3,
    batch, 1]`` for embeds)."""
    rng = np.random.default_rng(seed + pos)
    positions = torch.full((batch, 1), pos, dtype=torch.long, device=device)
    if cfg.inputs == "embeds":
        emb = rng.standard_normal((batch, 1, cfg.d_model)) * 0.02
        return {"embeds": torch.from_numpy(emb).to(device, torch.bfloat16),
                "positions": positions.expand(3, batch, 1)}
    if cfg.inputs == "codes":
        codes = rng.integers(0, cfg.vocab, (batch, cfg.codebooks, 1))
        return {"codes": _tensor(codes, device), "positions": positions}
    tokens = rng.integers(0, cfg.vocab, (batch, 1))
    return {"tokens": _tensor(tokens, device), "positions": positions}


# ------------------------------------------------------------------ drivers
def trace_arch(arch: str, mode: str = "forward", *, batch: int = 2,
               seq: int = 16, decode_steps: int = 2, smoke: bool = True,
               cfg: CaptureConfig | None = None, seed: int = 0,
               device="cuda", backend: str | None = None,
               params: dict | None = None,
               capture: TraceCapture | None = None,
               arch_config=None) -> TraceReport:
    """Trace one registry architecture end to end, with random float32
    masters from ``seed`` (or ``params``, e.g. converted from the JAX
    package) run in the config's compute dtype, into ``capture`` (a new
    one of ``cfg`` by default). ``arch_config`` runs in place of the
    registry's config (e.g. its published widths cut in depth).

    mode:
      forward -- the full-sequence forward and the output head, matmuls
                 on the plain path (training-shaped).
      decode  -- an untraced prefill of the batch, then
                 ``decode_steps`` traced decode steps (their matmuls
                 through ``backend``: the gated kernel on the card);
                 per-site statistics accumulate across steps.
    """
    from repro_torch.apps import check_device
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    if mode not in ("forward", "decode"):
        raise ValueError(f"unknown trace mode {mode!r}")
    device = check_device(device, "trace_arch")
    cap = capture or TraceCapture(cfg or make_capture_config(backend=backend))
    cfg = cap.cfg
    acfg = arch_config or get_config(arch, smoke=smoke)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = lm.init_model(acfg, gen)
    weights = lm.compute_weights(
        {k: _to(v, device) for k, v in params.items()}, acfg)
    skipped: list[str] = []
    inputs, positions = lm.model_input(
        acfg, model_inputs(acfg, batch, seq, seed, device))
    with torch.no_grad():
        if mode == "forward":
            # the output head too: the D x V projection is usually the
            # largest matmul, and decode mode traces it as well
            def fn(w, x, pos):
                h = lm.apply_model(w, acfg, x, pos)[0]
                return lm.logits_fn(w, acfg, h)
            _, sk = trace_fn(fn, weights, inputs, positions, emit=cap,
                             include_conv=cfg.include_conv, name=arch)
            skipped.extend(sk)
        else:
            prefill = lm.make_prefill_step(acfg, seq + decode_steps)
            _, states = prefill(weights, inputs, positions)
            decode = lm.make_decode_step(acfg, backend or "auto")
            for t in range(decode_steps):
                step = lm.model_input(acfg, decode_inputs(
                    acfg, batch, seq + t, seed, device))
                _, sk = trace_fn(decode, weights, states, *step, emit=cap,
                                 include_conv=cfg.include_conv, name=arch)
                skipped.extend(sk)
    return build_report(cap, f"{arch}[{mode}]", tuple(dict.fromkeys(skipped)))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def trace_cnn(net: str = "resnet50", *, n_images: int = 1, res: int = 112,
              cfg: CaptureConfig | None = None, seed: int = 0,
              device="cuda", backend: str | None = None,
              params=None, capture: TraceCapture | None = None
              ) -> TraceReport:
    """Trace a CNN inference (:func:`repro_torch.apps.cnn.nets.
    make_forward` on ``synthetic_images``): every convolution as its
    im2col matmul, MobileNet's depthwise convolutions as ``"dwconv"``
    batches, and the fc. Weights from ``seed``, or ``params``; sites into
    ``capture`` (a new one of ``cfg`` by default)."""
    from repro_torch.apps import check_device
    from repro_torch.apps.cnn import nets

    device = check_device(device, "trace_cnn")
    cap = capture or TraceCapture(cfg or make_capture_config(backend=backend))
    if params is None:
        params = nets.init_params(net, seed, device)
    fwd = nets.make_forward(net, seed=seed, params=params)
    images = nets.synthetic_images(n_images, res=res, seed=seed + 7,
                                   device=device)
    _, skipped = trace_fn(fwd, images, emit=cap,
                          include_conv=cap.cfg.include_conv, name=net)
    return build_report(cap, f"{net}[{res}px]", tuple(skipped))


# -------------------------------------------------------------------- sweep
@dataclasses.dataclass
class SweepCell:
    model: str
    geometry: str
    segments: str
    report: TraceReport

    def row(self) -> dict:
        return {"model": self.model, "geometry": self.geometry,
                "segments": self.segments, **self.report.summary()}


def run_sweep(archs: tuple[str, ...] = ("qwen1.5-0.5b",),
              nets: tuple[str, ...] = (),
              geometries: tuple[str, ...] = ("paper16", "mxu128"),
              segments: tuple[str, ...] = ("mantissa",),
              mode: str = "forward", batch: int = 2, seq: int = 16,
              res: int = 112, seed: int = 0, backend: str | None = None,
              device="cuda", smoke: bool = True) -> list[SweepCell]:
    """Trace every (model x geometry x BIC segments) cell. Each cell runs
    the model anew: keeping the traced operands across cells would save
    the forwards but hold every operand in memory."""
    cells = []
    for geom in geometries:
        for seg in segments:
            ccfg = make_capture_config(geom, seg, backend=backend)
            for arch in archs:
                rep = trace_arch(arch, mode, batch=batch, seq=seq,
                                 cfg=ccfg, seed=seed, device=device,
                                 backend=backend, smoke=smoke)
                cells.append(SweepCell(arch, geom, seg, rep))
            for net in nets:
                rep = trace_cnn(net, res=res, cfg=ccfg, seed=seed,
                                device=device, backend=backend)
                cells.append(SweepCell(net, geom, seg, rep))
    return cells


def format_sweep(cells: list[SweepCell]) -> str:
    hdr = (f"{'model':26s} {'geom':8s} {'bic':9s} {'sites':>5s} "
           f"{'zero%':>6s} {'stream-save%':>12s} {'total-save%':>11s} "
           f"{'stream-share%':>13s}")
    lines = [hdr, "-" * len(hdr)]
    for c in cells:
        s = c.report.summary()
        lines.append(
            f"{c.model:26s} {c.geometry:8s} {c.segments:9s} "
            f"{s['n_sites']:5d} {s['mean_zero_fraction']*100:6.1f} "
            f"{s['streaming_saving']*100:12.1f} "
            f"{s['total_saving']*100:11.1f} "
            f"{s['streaming_share']*100:13.1f}")
    return "\n".join(lines)
