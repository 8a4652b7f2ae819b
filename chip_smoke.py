#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds every CUDA source of the port (one ``nvcc`` each, all at
once: six libraries) and drives the port's main paths, each with the
kernels' launch counts set to 0 just before it and read just after:

* the paper's CNN power measurement, ``analyze_network("resnet50")`` at
  224 px with the whole design menu, then ``select_network``: every
  site's counters are held against the plain version, and MobileNetV1 at
  224 px runs the same way through the batched depthwise form. Kernel:
  the power-counter pass (K1).
* per-request power-accounted LM serving: the slot ``ServeEngine`` at
  the full width of Qwen1.5-0.5B (random bf16 weights from seed 0), 8
  requests through 4 slots. Kernels: the ZVG-gated decode matmul (K2) in
  every projection, MLP and lm-head matmul, the decode matmul fused with
  its counters (K3) in the power accountant, K1 in its prefill
  accounting. The same requests then run with ``kernel_backend="ref"``
  (every plain version) and the two runs' tokens and energies are
  compared.
* paged power-accounted serving: ``ServeConfig(paging=PagingConfig(...))``
  at the same width. Kernel: the paged decode attention (K4), once a
  layer a decode step, beside K1-K3. (a) With ample pages it serves the
  slot run's requests with the slot engine's tokens and energies; (b) at
  the slot run's memory it serves 16 requests with a shared system
  prompt through 8 rows, with chunked prefill, shared prefixes and two
  classes; (c) with half the pages it must preempt. The greedy tokens of
  (b) and (c) are held against an uncontended run, and (b) against
  itself with every plain version.
* the quickstart, ``repro_torch.apps.quickstart.run(device="cuda")``:
  the paper pair's stream report, BIC on the weight bus and its toggles,
  the tile-gated matmul and the design menu. Kernels: the transition
  counter (K5), the BIC encoder (K6), the tile-gated matmul (K7) and K1.
  It is held against the same run with every plain version, and prints
  the JAX example's six lines. Then K5-K7 run at full width on every
  ResNet50 site at 224 px (one synthetic image): K6 on the weight words,
  K5 on them, their mantissa field and K6's output, K7 on the operands
  in bf16. K5 and K6 are held to K1's rows of the same words, and K5-K7
  to their plain versions, on every site. K6's plain version walks T in
  Python (some 55 k steps over the 54 sites); that one walk is also K6's
  plain time.
* the model-wide power tracer, ``repro_torch.trace``: Qwen1.5-0.5B at
  full width (random bf16 weights from seed 0) traced over a forward at
  batch 2, seq 16 (217 sites) and over 3 decode steps after a prefill
  (every site called 3 times), ResNet50 (54 sites) and MobileNetV1 (28,
  13 depthwise) at 224 px. Kernels: K1 for every site's counters, K2 in
  the decode steps' matmuls. Each trace is run cold, warm and under the
  profiler; its recorded sites, fed through a capture with every plain
  version, must give bitwise the same counters; then a two-geometry
  sweep over Qwen1.5-0.5B and ResNet50.
* the design sweep, ``repro_torch.design.sweep``: ``collect_sites`` over
  ResNet50 and MobileNetV1 at 224 px and the smoke Qwen1.5-0.5B,
  Granite-3.0-2B and Phi-3.5-MoE (145 sites fitted to 96 x 96 x 96), then
  ``build_sweep_report`` over the 320-point geometry x coding x precision
  x approx grid. Kernel: K1, once an edge on each of the 24 (geometry,
  precision) groups, bf16 and the embedded fp8/int8 words. Its rows must
  be identical to the plain versions' and the JAX package's golden
  floors must hold.
* the LM zoo at its published widths (random bf16 weights from seed 0):
  Granite-3.0-2B cut to 8 of 40 layers, Phi-3.5-MoE to 4 of 32,
  DeepSeek-67B to 2 of 95, MiniCPM3-4B to 8 of 62 (MLA with q-LoRA),
  DeepSeek-V2-Lite to 4 of 27 (MLA, 64 experts), RecurrentGemma-9B to 14
  of 38 (RG-LRU and local attention), xLSTM-1.3B to 16 of 48,
  MusicGen-medium to 8 of 48 (codes), Qwen2-VL-72B to 2 of 80 (M-RoPE
  over embeds), each
  traced over a forward (batch 2, seq 16) and 3 decode steps. Kernels: K1
  for every site's counters (held bitwise to the plain versions' at every
  site), K2 in every decode matmul the JAX package runs through its
  backend (site and launch counts as counted per mixer), whose greedy
  picks must equal the plain run's (or part only at a top-2 tie); K2
  timed at each new shape beside ``torch.matmul`` (up to Qwen2-VL's
  8192 x 152064 head).
* the slot engine with power accounting on MiniCPM3-4B whole and
  RecurrentGemma-9B at 14 layers (prompts at their exact lengths), 4
  requests through 2 slots with the kernels and with every plain version:
  tokens and energies equal. Kernels: K1 (prefill accounting), K2, K3.
  MiniCPM3-4B then serves paged (its latent caches in pages of 16): with
  an ample pool it must give the slot run's tokens and energies, and so
  must its plain run; the same prompts behind a shared 32-token prefix
  must hit the prefix cache and give their own plain run's. No K4 there:
  MLA gathers its pages, as the JAX package does.
* windowed telemetry with the loop closed (``TelemetryConfig(window=2,
  actuate=True)``) on the serving main path: the slot run's 8 requests
  and paged run (b), each with the kernels (K1-K3, K4 in the paged run)
  and with every plain version -- the windows' counters bitwise, the
  same flip and swap timeline, the actuated totals and savings tracks
  within rtol 1e-6, the windows summing to ``trace_report()`` bit for
  bit, the telemetry's host time a retirement logged -- then the JAX
  package's three traffic scenarios at their smoke configs through
  ``run_scenario(device="cuda")``, against their plain runs, where
  ``shift`` must flip its prefill sites from mant-exp to bic-west.
* training, ``repro_torch.launch.train.train``: Qwen1.5-0.5B at full
  width from float32 masters (seed 0) on ``SyntheticLM`` batches of 8 x
  256, 8 AdamW steps with the power monitor on every step and a
  model-wide trace every 4. Kernel: K1, in the monitor (held to the
  plain counters on the same updated params every step) and in every
  traced site (held bitwise to a plain capture). The losses must be
  finite and fall; the final state is checkpointed and restored
  bitwise; a 2-layer cut of the model, stopped and resumed from its
  checkpoint, must end at the straight run's loss; the int8 gradient
  compression must give the CPU's bits on the card. A warm step is then
  split by part and profiled, after the other profiles.
* the benchmark drivers, ``repro_torch.bench.run.run_suites`` on the
  card: the paper's tables and figures (Fig. 2, the BIC variant grid,
  Figs. 4/5, the overall table, the overhead scaling), the stream and
  counter kernels against their plain versions, the monitor on LM
  operands, and slot, paged and fused serving at the JAX benchmarks'
  smoke sizes, with the analysis cache in a fresh directory; then the
  three drivers earlier phases cover, with ``quick``. No suite may fail;
  K1-K3 and K5-K7 must launch and K4 must not; the CNN analyses must
  equal the main path's bitwise; the fused counter pass must report
  integer equality; ``BENCH_serve.json`` and ``BENCH_kernels.json`` must
  pass their schemas.

The build prints ptxas's registers, shared memory and spills for the
streaming decode matmul (K2), K3's chunked counter walk, the split-KV
paged attention (K4), the wgmma tile-gated matmul (K7), K1's grouped
counter walk, K6's chunked invert scan and K5's vector-load counter, and
K7's library must hold wgmma and TMA-load instructions in its SASS; then
the plans of K3
(product split, walk chunks) and K4 (position split) at the serving
shapes, K1's at the CNN and prefill launches it times one by one and
K6's at three weight streams, K5's at four weight streams, the
quickstart's words and its card cases. Before the main paths, each kernel
is held against its plain PyTorch version on the card (counters bitwise,
K1, K5 and K6 also at every edge of their plans; products within a stated
tolerance; K4 in bfloat16 also per element against the float32 plain
version, which must catch a planted fault in all 80 cases), and so are
the operands the kernels once refused (K7 at any blocks, K2 on int8 and
at K past 32768); after them, each is timed at its main path's shapes
with CUDA events and the profiler (K1 over ResNet50's 108 and
MobileNetV1's 56 launches by both, and at each launch of
``K1_PLAN_SHAPES``; K3 per call and per launch, beside K2 alone at K3's
product shape; K4 per launch and per paged step beside gather + SDPA;
K5 over the 54 weight streams and on the largest alone).
The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the float32
#: non-tensor rate, which bounds integer ALU work from above, and the
#: dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

KERNEL_SOURCE = "src/repro_torch/csrc/power_counters.cu"
KERNEL_REPLACES = "src/repro/kernels/power_counters/kernel.py:335"
ZVG_SOURCE = "src/repro_torch/csrc/zvg_matmul.cu"
K2_REPLACES = "src/repro/kernels/zvg_matmul/fused.py:96"
K3_REPLACES = "src/repro/kernels/zvg_matmul/fused.py:179"
K4_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
K4_REPLACES = "src/repro/kernels/zvg_matmul/fused.py:259"
K5_SOURCE = "src/repro_torch/csrc/transitions.cu"
K5_REPLACES = "src/repro/kernels/transitions/kernel.py:42"
K6_SOURCE = "src/repro_torch/csrc/bic_encode.cu"
K6_REPLACES = "src/repro/kernels/bic_encode/kernel.py:73"
K7_SOURCE = "src/repro_torch/csrc/zvg_tiled_matmul.cu"
K7_REPLACES = "src/repro/kernels/zvg_matmul/kernel.py:70"

#: decode products of the kernels (K2, K3) and of their plain versions
#: against the float32 product of the same operands, per output dtype:
#: |out - f32| <= REL * |f32| + ACC * (|x| @ |w|). ACC covers float32 sums
#: taken in another order (below 1e-7 of |x| @ |w| at the decode shapes
#: on an H100; the worst case is K * 2**-24), REL the bfloat16 output's
#: rounding (half a unit in the last place, 2**-9, doubled for room);
#: results below the smallest normal float32 (2**-126) count as zero.
#: int8 x int8 (no served path runs it) is exact: equal to the plain
#: version, ``x @ w`` mod 256.
PRODUCT_TOL = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0 ** -8, 1e-5),
               torch.int8: (0.0, 0.0)}
#: a greedy token of the kernel run may differ from the plain run's only
#: where the plain run's top two logits lie closer than this: two bf16
#: units in the last place at the logits' magnitude (|logit| < 64)
LOGIT_TIE = 0.5

#: the serving main path: Qwen1.5-0.5B at full width
SERVE_ARCH = "qwen1.5-0.5b"
SERVE_REQUESTS = 8
SERVE_SLOTS = 4
SERVE_CACHE = 256
SERVE_MAX_NEW = 32
SERVE_STOCHASTIC = (2, 5)     # temperature 0.8, top-k 5; the rest greedy

#: (K, N) of the decode matmuls of Qwen1.5-0.5B: wq/wk/wv/wo, ffn up and
#: gate, ffn down, lm head
DECODE_SHAPES = ((1024, 1024), (1024, 2816), (2816, 1024), (1024, 151936))

#: K4 is held to its plain version over its case list (and stated
#: tolerance, ``repro_torch.kernels.zvg_matmul.cases``) once per seed
PAGED_SEEDS = (0, 1, 2, 3, 4, 5, 6, 7)

#: the paged runs: Qwen1.5-0.5B at full width, pages of 16 positions
PAGE = 16
PAGED_REQUESTS = 16
PAGED_ROWS = 8
PAGED_HI = (0, 5, 10, 15)           # the "hi" class (priority 1)
PAGED_STOCHASTIC = (3, 7, 11, 14)   # temperature 0.8, top-k 5
PAGED_SYSTEM = 64                   # shared system-prompt tokens


#: the K1 launches whose plans are logged and times kept one by one,
#: (B, T, L): ResNet50's stem and s4b1.c2 edges, MobileNetV1's first and
#: last depthwise batches, the serving accountant's prefill edges
#: (Qwen1.5-0.5B, K sampled to 1024: 128 prompt rows west, 256 columns
#: north)
K1_PLAN_SHAPES = {"resnet50 stem west": (1, 147, 12544),
                  "resnet50 stem north": (1, 147, 64),
                  "resnet50 s4b1.c2 west": (1, 4608, 64),
                  "resnet50 s4b1.c2 north": (1, 4608, 512),
                  "mobilenet dw1 west": (32, 9, 12544),
                  "mobilenet dw13 west": (1024, 9, 64),
                  "prefill west": (1, 1024, 128),
                  "prefill north": (1, 1024, 256)}


#: K5's logged weight streams ``(T, L)`` (uint16): ResNet50's stem,
#: a stage-1 3x3, the largest (s4 3x3) and the fc
K5_PLAN_SHAPES = ((147, 64), (576, 64), (4608, 512), (2048, 1000))


#: the redesigned kernels, by library: their ptxas lines (registers,
#: shared memory, spills) are printed after the build
REDESIGNED = {"zvg_matmul": ("stream_kernel", "walk_kernel"),
              "paged_attention": ("split_attention_kernel",),
              "zvg_tiled_matmul": ("wgmma_kernel", "gate_kernel"),
              "power_counters": ("counters_kernel",),
              "bic_encode": ("bic_encode_kernel",),
              "transitions": ("transitions_kernel",)}


def ptxas_summary(name: str, kernels) -> list[str]:
    """One line per compiled entry of ``kernels`` in ``name``'s build log:
    its template arguments, registers, shared memory and spill bytes."""
    from repro_torch.kernels import _build

    lines, entry = [], None
    for line in (_build.BUILD / f"{name}.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry, spill = next((k for k in kernels if k in line), None), ""
            args = line.split(entry)[1].split("EEv")[0] if entry else ""
        elif entry and "spill stores" in line:
            spill = line.split("bytes stack frame,")[1].strip()
        elif entry and "Used" in line and "registers" in line:
            lines.append(f"{entry}{args}: {line.split('Used', 1)[1].strip()}"
                         f"; {spill}")
            entry = None
    return lines


def sass_check(lib: Path) -> None:
    """K7's bf16 route must run on wgmma fed by TMA: its library's SASS
    holds HGMMA (warpgroup MMA) and UTMALDG (TMA load) instructions."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    if not all(counts.values()):
        raise AssertionError(f"zvg_tiled_matmul SASS lacks wgmma or TMA "
                             f"loads: {counts}")
    log(f"zvg_tiled_matmul SASS: {json.dumps(counts)} (wgmma on TMA-fed "
        f"tiles)")


def log_plans() -> None:
    """The plans of the redesigned kernels at their main path's shapes:
    K3's product split and counter chunks (Qwen1.5-0.5B's accountant: 4 x
    1024 x 256, float32 weights), K4's split (8 rows, 16 KV heads, 16
    pages of 16), K1's at :data:`K1_PLAN_SHAPES` and K6's at ResNet50's
    largest and smallest weight streams and the quickstart's."""
    from repro_torch.kernels.bic_encode.kernel import bic_plan
    from repro_torch.kernels.power_counters.kernel import (chunk_plan,
                                                           counter_plan)
    from repro_torch.kernels.transitions.cases import TRANSITION_SHAPES
    from repro_torch.kernels.transitions.kernel import transitions_plan
    from repro_torch.kernels.zvg_matmul import kernel as kz

    log(f"plan K3 product: {kz.decode_plan(1024, 256, 4)}")
    log(f"plan K3 walk: {chunk_plan(1024)} (32-lane groups: 4 west + 8 "
        f"north, {12 * chunk_plan(1024).cluster} blocks)")
    log(f"plan K4: {kz.paged_plan(SERVE_CACHE // PAGE, PAGE, PAGED_ROWS, 16)}")
    for label, shape in K1_PLAN_SHAPES.items():
        plan = counter_plan(*shape)
        log(f"plan K1 {label} {shape}: {plan} ({plan.route})")
    for T, L in ((4608, 512), (147, 64), (512, 128)):
        plan = bic_plan(T, L)
        log(f"plan K6 {(T, L)}: {plan} ({plan.route})")
    for T, L, wb in ([(T, L, 2) for T, L in K5_PLAN_SHAPES]
                     + [(512, 128, 4)]
                     + [(T, L, wb) for T, L in TRANSITION_SHAPES
                        for wb in (2, 4)]):
        plan = transitions_plan(T, L, wb)
        log(f"plan K5 {(T, L)} {wb}-byte words: {plan} ({plan.warps} "
            f"warps)")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ comparisons
def adversarial_words(T: int, L: int, gen: torch.Generator,
                      batch: int | None = None) -> torch.Tensor:
    """Random words, ~60% zero words, with NaN, -0.0 and subnormal words
    mixed in, as int32 on the card."""
    shape = (T, L) if batch is None else (batch, T, L)
    x = torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32)
    r = torch.rand(shape, generator=gen)
    x[r < 0.60] = 0
    x[(r >= 0.60) & (r < 0.62)] = 0x8000              # -0.0
    x[(r >= 0.62) & (r < 0.64)] = 0x7FC0              # NaN
    x[(r >= 0.64) & (r < 0.65)] = 0xFFC1              # -NaN, payload
    x[(r >= 0.65) & (r < 0.67)] = torch.randint(      # subnormals
        1, 0x80, (int(((r >= 0.65) & (r < 0.67)).sum()),), generator=gen,
        dtype=torch.int32)
    return x.cuda()


def assert_kernel_matches(x: torch.Tensor, spec, ctx: str,
                          words: torch.Tensor | None = None) -> int:
    """Kernel on ``words`` (default ``x``) vs the plain version on ``x``,
    on the card, bitwise; returns the largest absolute difference (0)."""
    from repro_torch.kernels.power_counters import kernel
    from repro_torch.kernels.power_counters.ref import fused_counters_ref

    kc, kr = kernel.fused_counters_cuda(x if words is None else words, spec)
    pc, pr = fused_counters_ref(x, spec)
    torch.cuda.synchronize()
    err = max(int((kc.long() - pc.long()).abs().max()),
              int((kr.long() - pr.long()).abs().max()))
    if not (torch.equal(kc, pc) and torch.equal(kr, pr)):
        bad = [spec.rows[i] for i in range(spec.n_rows)
               if not torch.equal(kc[..., i, :], pc[..., i, :])]
        raise AssertionError(f"kernel != plain version ({ctx}): rows {bad}, "
                             f"rowzeros equal {torch.equal(kr, pr)}")
    return err


def phase_kernel_cases() -> int:
    from repro_torch.core import bic
    from repro_torch.kernels.power_counters import CounterSpec
    from repro_torch.kernels.power_counters.cases import PLAN_EDGES

    gen = torch.Generator().manual_seed(0)
    full = CounterSpec(bic_variants=tuple(bic.NAMED_SEGMENTS.values()),
                       zvg=True, hist=True)
    singles = tuple((1 << b,) for b in range(15))
    pairs = tuple(((1 << b) | (1 << ((b + 3) % 16)),) for b in range(16))
    seg31 = CounterSpec(bic_variants=singles + pairs
                        + (tuple(1 << b for b in range(15)),), zvg=True)
    assert len(seg31.unique_segments) == 31
    err, n = 0, 0
    for T in (1, 7, 257, 4609):
        for L in (1, 33, 12544):
            x = adversarial_words(T, L, gen)
            err = max(err, assert_kernel_matches(x, full, f"full {T}x{L}"))
            # the same words as uint16
            err = max(err, assert_kernel_matches(
                x, full, f"full uint16 {T}x{L}",
                words=x.to(torch.int16).view(torch.uint16)))
            n += 2
    for T, L in ((7, 33), (257, 129), (4609, 64)):
        err = max(err, assert_kernel_matches(adversarial_words(T, L, gen),
                                             seg31, f"31 segments {T}x{L}"))
        n += 1
    for B, T, L in ((5, 257, 33), (64, 9, 3136), (3, 4609, 20),
                    (7, 1025, 45), (1024, 9, 64), (2, 129, 12544)):
        x = adversarial_words(T, L, gen, batch=B)
        err = max(err, assert_kernel_matches(x, full, f"batch {B}x{T}x{L}"))
        n += 1
    # the plan's edges: one pass, a block's chunks, clusters of 4-16
    for T in PLAN_EDGES:
        for L in (1, 33):
            x = adversarial_words(T, L, gen)
            err = max(err, assert_kernel_matches(
                x, full, f"edge {T}x{L}",
                words=x.to(torch.int16).view(torch.uint16)))
            err = max(err, assert_kernel_matches(x, full, f"edge {T}x{L}"))
            n += 2
    err = max(err, assert_kernel_matches(adversarial_words(4609, 40, gen),
                                         seg31, "31 segments 4609x40"))
    n += 1
    log(f"kernel vs plain on the card: {n} cases bitwise equal "
        f"(max_abs_err {err})")
    return err


# -------------------------------------------------------------- main path
def site_streams(trace, geom, precision):
    """The edge streams the analysis counts for one traced layer."""
    from repro_torch.apps.cnn import analysis
    from repro_torch.core import systolic

    A, W = analysis.matmul_operands(trace)
    return systolic.edge_streams(A, W, geom, precision)


def check_sites(net: str, layers, designs) -> tuple[list, int]:
    """Re-trace ``net`` (cuDNN is deterministic here, so the operands are
    the main path's) and hold every site's counters from the kernel
    against the plain version, and its energies against the main path's.
    Returns the per-site (name, west stream, west spec, north stream,
    north spec) and the largest counter difference."""
    from repro_torch import design as D
    from repro_torch.apps.cnn import analysis, nets
    from repro_torch.kernels.power_counters import CounterSpec

    images = nets.synthetic_images(1, 224, seed=7, device="cuda")
    traces = nets.forward_with_traces(net, images, seed=0)
    ((geom, precision), kw), = D.menu_args(designs).items()
    wspec = CounterSpec(bic_variants=kw["west_bic"], zvg=kw["west_zvg"])
    nspec = CounterSpec(bic_variants=kw["north_bic"], zvg=kw["north_zvg"])
    sites, err = [], 0
    for t, lp in zip(traces, layers):
        a_bits, b_bits = site_streams(t, geom, precision)
        err = max(err, assert_kernel_matches(a_bits, wspec, f"{t.name} west"))
        err = max(err, assert_kernel_matches(b_bits, nspec, f"{t.name} north"))
        ref = analysis.analyze_trace(t, designs=designs, backend="ref")
        if ref.designs != lp.designs:
            raise AssertionError(f"{net} {t.name}: energies from the plain "
                                 f"counters differ from the main path's")
        sites.append((t.name, a_bits, wspec, b_bits, nspec))
    log(f"{net}: all {len(sites)} sites' counters equal the plain version's "
        f"on the card, and their energies the main path's")
    return sites, err


def run_main_path(net: str, designs, n_sites: int):
    from repro_torch.apps.cnn import analysis
    from repro_torch.kernels.power_counters import kernel

    torch.cuda.synchronize()
    kernel.fused_counters_cuda.launches = 0
    t0 = time.perf_counter()
    layers = analysis.analyze_network(net, n_images=1, designs=designs,
                                      device="cuda", res=224)
    sel = analysis.select_network(layers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.fused_counters_cuda.launches
    if launches != 2 * n_sites:
        raise AssertionError(f"{net}: the counter kernel ran {launches} "
                             f"times, expected 2 x {n_sites}")
    if len(layers) != n_sites:
        raise AssertionError(f"{net}: {len(layers)} layers, expected "
                             f"{n_sites}")
    s = sel.summary()
    counts: dict[str, int] = {}
    for name in sel.choices.values():
        counts[name] = counts.get(name, 0) + 1
    for l in layers:
        vals = [l.zero_fraction, l.energy_base, l.energy_prop] + [
            r["total"] for r in l.designs.values()]
        if not all(v == v and abs(v) != float("inf") for v in vals):
            raise AssertionError(f"{net} {l.name}: non-finite result")
    if not (0.0 < s["saving_fixed"] <= s["saving_selected"] < 1.0):
        raise AssertionError(f"{net}: implausible savings {s}")
    log(f"{net} @ 224 px main path: {len(layers)} sites, kernel launches "
        f"{launches}, wall {wall:.3f} s, saving_selected "
        f"{s['saving_selected']!r}, saving_fixed {s['saving_fixed']!r}, "
        f"sites per design {json.dumps(counts, sort_keys=True)}")
    return layers, launches, wall


#: the model-wide traces at full width: Qwen1.5-0.5B's forward at batch
#: 2, seq 16 (24 layers x 9 matmuls + the head) and 3 decode steps after
#: a prefill, ResNet50 and MobileNetV1 at 224 px (53 convs + fc; 27 + fc,
#: 13 of them depthwise)
TRACE_RUNS = {"qwen1.5-0.5b forward": 24 * 9 + 1,
              "qwen1.5-0.5b decode": 24 * 9 + 1,
              "resnet50": 54, "mobilenet": 28}
TRACE_DECODE_STEPS = 3


def trace_run(label: str, capture):
    """One trace of ``TRACE_RUNS[label]`` into ``capture``, on the card
    with the kernels (K1 for every site's counters, K2 in the decode
    steps' matmuls)."""
    from repro_torch.trace import sweep as sw

    if label.startswith(SERVE_ARCH):
        return sw.trace_arch(SERVE_ARCH, label.split()[-1], batch=2, seq=16,
                             decode_steps=TRACE_DECODE_STEPS, smoke=False,
                             capture=capture)
    return sw.trace_cnn(label, res=224, capture=capture)


def phase_trace() -> dict:
    """The model-wide tracer (``repro_torch.trace``) at full width, each
    trace of :data:`TRACE_RUNS` cold (K1 and K2 launches counted, its
    sites recorded) and warm (host clock, synchronized); its profile
    comes after the timing phases (:func:`phase_trace_busy`). Each must
    give its site
    count, unique names under its model's name, the kinds of its matmuls
    (MobileNetV1's 13 depthwise convolutions as ``"dwconv"``), every
    decode site called once a step, and ``0 < streaming_saving < 1``,
    ``0 < streaming_share < 1``; the recorded sites fed through a capture
    with every plain version (``backend="ref"``) must give bitwise the
    same counters at every site. Then a two-geometry sweep (``paper16``,
    ``mxu128``) over Qwen1.5-0.5B and ResNet50 at full width."""
    import dataclasses

    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.trace import sweep as sw
    from repro_torch.trace.capture import TraceCapture

    class Recording(TraceCapture):
        """A capture that keeps every site it records."""

        def __init__(self, cfg):
            super().__init__(cfg)
            self.recorded = []

        def record(self, site):
            self.recorded.append(site)
            super().record(site)

    cfg = sw.make_capture_config()
    ref_cfg = dataclasses.replace(cfg, monitor=dataclasses.replace(
        cfg.monitor, backend="ref"))
    out = {}
    for label, n_sites in TRACE_RUNS.items():
        counted = (k1.fused_counters_cuda, kz.gated_row_matmul_cuda)
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        cap = Recording(cfg)
        t0 = time.perf_counter()
        rep = trace_run(label, cap)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        t0 = time.perf_counter()
        trace_run(label, TraceCapture(cfg))
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        names = [s.name for s in rep.sites]
        kinds = [s.kind for s in rep.sites]
        prefix = label.split()[0] + "/"
        if len(names) != n_sites or len(set(names)) != n_sites or not all(
                n.startswith(prefix) and "/dot#" in n for n in names):
            raise AssertionError(f"trace {label}: {len(names)} sites, "
                                 f"expected {n_sites} named {prefix}...")
        steps = TRACE_DECODE_STEPS if label.endswith("decode") else 1
        if any(s.calls != steps for s in rep.sites):
            raise AssertionError(f"trace {label}: calls "
                                 f"{sorted({s.calls for s in rep.sites})}, "
                                 f"expected {steps} at every site")
        want_dw = 13 if label == "mobilenet" else 0
        if kinds.count("dwconv") != want_dw or (
                label in ("resnet50", "mobilenet")
                and kinds.count("conv") != n_sites - 1 - want_dw):
            raise AssertionError(f"trace {label}: kinds {kinds}")
        if launches["fused_counters_cuda"] != 2 * len(cap.recorded) or (
                launches["gated_row_matmul_cuda"]
                != (169 * steps if label.endswith("decode") else 0)):
            raise AssertionError(f"trace {label}: launches {launches} for "
                                 f"{len(cap.recorded)} recorded calls")
        sm = rep.summary()
        if not (0.0 < sm["streaming_saving"] < 1.0
                and 0.0 < sm["streaming_share"] < 1.0):
            raise AssertionError(f"trace {label}: implausible {sm}")
        ref = TraceCapture(ref_cfg)
        for site in cap.recorded:
            ref.record(site)
        for name, acc in cap.sites.items():
            r = ref.sites[name]
            if (r.counters != acc.counters or r.zf_sum != acc.zf_sum
                    or r.calls != acc.calls):
                raise AssertionError(f"trace {label} {name}: counters with "
                                     f"the kernels differ from the plain "
                                     f"versions'")
        out[label] = {
            "sites": n_sites, "calls": len(cap.recorded),
            "wall_cold_s": cold, "wall_warm_s": warm,
            "launches": launches,
            "streaming_saving": sm["streaming_saving"],
            "total_saving": sm["total_saving"],
            "streaming_share": sm["streaming_share"],
            "mean_zero_fraction": sm["mean_zero_fraction"]}
        log(f"trace {label} at full width: {n_sites} sites ("
            f"{len(cap.recorded)} calls, kinds "
            f"{json.dumps({k: kinds.count(k) for k in sorted(set(kinds))})}"
            f"), wall cold {cold:.3f} s, warm {warm:.3f} s, launches "
            f"{json.dumps(launches)}; streaming saving "
            f"{sm['streaming_saving']!r}, total {sm['total_saving']!r}, "
            f"streaming share {sm['streaming_share']!r}; counters with the "
            f"kernels bitwise equal to the plain versions' at every site")
    t0 = time.perf_counter()
    cells = sw.run_sweep(archs=(SERVE_ARCH,), nets=("resnet50",),
                         geometries=("paper16", "mxu128"), res=224,
                         smoke=False)
    log(f"trace sweep at full width ({time.perf_counter() - t0:.1f} s):")
    for line in sw.format_sweep(cells).splitlines():
        log(line)
    out["sweep"] = [{k: v for k, v in c.row().items()
                     if k != "design_savings"} for c in cells]
    return out


#: phase_sweep: the design sweep's workloads -- ResNet50 and MobileNetV1
#: at 224 px (one image), the three smoke LMs -- fitted to the default
#: 96 x 96 x 96 sample, priced over the full 320-point grid
SWEEP_NETS = ("resnet50", "mobilenet")
SWEEP_ARCHS = ("qwen1.5-0.5b", "granite-3-2b", "phi3.5-moe-42b-a6.6b")
SWEEP_SITES = 54 + 28 + 19 + 19 + 25


def phase_sweep() -> tuple[dict, object]:
    """The design sweep (``repro_torch.design.sweep``): ``collect_sites``
    over :data:`SWEEP_NETS` and :data:`SWEEP_ARCHS` on the card, then
    ``build_sweep_report`` over the 320-point grid with K1 on every
    ``(geometry, precision)`` group (24 groups, one launch an edge), cold
    and warm, and once more with every plain version. The two reports'
    rows must be identical (the same integer counters, so the same float
    energies), and the JAX package's golden floors must hold
    (``check_goldens`` returns no failure). Returns the phase's numbers
    and the sites, which :func:`phase_sweep_busy` prices once more under
    the profiler."""
    from repro_torch.bench.design_sweep import best_vs_fixed, check_goldens
    from repro_torch.design import sweep as dsw
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.zvg_matmul import kernel as kz

    torch.cuda.synchronize()
    k1.fused_counters_cuda.launches = 0
    kz.gated_row_matmul_cuda.launches = 0
    t0 = time.perf_counter()
    sites = dsw.collect_sites(nets=SWEEP_NETS, archs=SWEEP_ARCHS, res=224)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    if len(sites.names) != SWEEP_SITES or sites.A.shape[1:] != (96, 96):
        raise AssertionError(f"sweep: {len(sites.names)} sites of "
                             f"{tuple(sites.A.shape)}, expected "
                             f"{SWEEP_SITES} of 96 x 96")
    designs = dsw.sweep_grid()
    if len(designs) != 320:
        raise AssertionError(f"sweep grid of {len(designs)} points")

    def price(backend):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = dsw.build_sweep_report(sites, designs, backend=backend)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    rep, cold_s = price("auto")
    launches = k1.fused_counters_cuda.launches
    _, warm_s = price("auto")
    ref, ref_s = price("ref")
    if launches != 2 * 24 or kz.gated_row_matmul_cuda.launches:
        raise AssertionError(f"sweep: {launches} K1 launches for 24 groups, "
                             f"{kz.gated_row_matmul_cuda.launches} of K2")
    if (rep.rows != ref.rows or rep.front != ref.front
            or rep.beats_fixed != ref.beats_fixed):
        bad = [r["name"] for r, p in zip(rep.rows, ref.rows) if r != p]
        raise AssertionError(f"sweep rows with K1 differ from the plain "
                             f"versions' at {bad[:8]}")
    fails = check_goldens(rep)
    if fails:
        raise AssertionError(f"sweep goldens: {fails}")
    front = [r["name"] for r in rep.front_rows()]
    best = best_vs_fixed(rep)
    log(f"sweep: {len(sites.names)} sites ({', '.join(SWEEP_NETS)} at 224 "
        f"px, {', '.join(SWEEP_ARCHS)} smoke) fitted to 96x96x96 in "
        f"{trace_s:.3f} s; 320 points priced cold {cold_s:.3f} s, warm "
        f"{warm_s:.3f} s (plain versions {ref_s:.3f} s), {launches} K1 "
        f"launches; rows identical to the plain versions'; goldens hold; "
        f"front ({len(front)}) {front}; {len(rep.beats_fixed)} points beat "
        f"the fixed design on streaming energy (best {best!r})")
    return {"sites": len(sites.names), "points": len(designs),
            "trace_wall_s": trace_s, "price_cold_s": cold_s,
            "price_warm_s": warm_s, "price_plain_s": ref_s,
            "launches": launches, "front": front,
            "beats_fixed": len(rep.beats_fixed),
            "best_streaming_vs_fixed": best}, sites


def phase_sweep_busy(sweep: dict, sites) -> None:
    """One more warm pricing of the 320-point grid under the profiler:
    K1's device time over its 48 launches and the card's total, added to
    ``sweep``. It runs after the timing phases, before the trace profiles:
    a profile this large left CUPTI delivering no device events to the
    small profiles after it (the K2 timings of :func:`zoo_k2`), and the
    trace profiles are larger still."""
    from repro_torch.design import sweep as dsw

    designs = dsw.sweep_grid()
    total, by = device_ms([lambda: dsw.build_sweep_report(
        sites, designs, backend="auto")], by_kernel=True)
    k1_ms = sum(v for k, v in by.items() if "counters_kernel" in k)
    sweep |= {"k1_device_ms": k1_ms, "device_ms": total}
    log(f"sweep pricing profiled: K1 device {k1_ms:.4f} ms over its 48 "
        f"launches, the card busy {total:.4f} ms in all (profiler)")


#: phase_zoo: the LM zoo at its published widths, each with the layers
#: kept: Granite-3.0-2B cut to 8 of its 40 layers (time: whole, it took a
#: large share of the phase on an NVIDIA H100 80GB HBM3 at 700 W, and
#: phase_bench needs the room), Phi-3.5-MoE to 4 of its 32 layers (42 B
#: parameters do not fit one 80 GB card in bf16), DeepSeek-67B to 2 of its
#: 95; MiniCPM3-4B to 8 of 62 (time: traced whole it took 53 s of the
#: script's ~600 on that card; :data:`ZOO_SERVING` serves it whole);
#: DeepSeek-V2-Lite to 4 of 27 (the dense head layer and 3 MoE layers:
#: 15.7 B parameters are ~94 GB as float32 masters plus bf16);
#: RecurrentGemma-9B to 14 of 38 (4 groups and the 2-block tail; memory
#: and time); xLSTM-1.3B to 16 of 48 (2 groups of 7 mLSTM and 1 sLSTM;
#: time: 40 s whole on that card); MusicGen-medium to 8 of 48 (time);
#: Qwen2-VL-72B to 2 of 80 (72 B parameters do not fit one card)
ZOO = (("granite-3-2b", 8), ("phi3.5-moe-42b-a6.6b", 4),
       ("deepseek-67b", 2), ("minicpm3-4b", 8),
       ("deepseek-v2-lite-16b", 4), ("recurrentgemma-9b", 14),
       ("xlstm-1.3b", 16), ("musicgen-medium", 8), ("qwen2-vl-72b", 2))
ZOO_DECODE_STEPS = 3
ZOO_SEQ = 16


def zoo_sites(acfg, seq: int = ZOO_SEQ) -> tuple[int, int, int]:
    """(forward sites at ``seq``, decode-step sites, K2 launches a decode
    step) of an arch, counted per mixer and FFN from the model's code, not
    read off the tracer. Sites: attention's 3 projections, 2 einsums a KV
    block of ``attn_block_k`` (local attention's 2 over all its query
    blocks; decode 2) and ``wo``; MLA's q path (``wq``'s einsum, or
    ``w_dq`` and ``w_uq``'s einsum), ``w_dkv``, ``w_kr``, the forward's
    two expansions and 2 einsums a KV block or the decode's five absorbed
    einsums, and ``wo``; the RG-LRU block's 5 products (decode: and its
    conv einsum); the mLSTM's 8 products and 5 einsums a chunk (decode:
    the conv einsum and the 2 of one recurrent step); the sLSTM's 3
    products and one einsum a step (decode: the conv einsum, 3 products,
    one step's einsum); an MLP's 3 (2 ungated), an MoE's router and 5
    einsums (and its shared MLP's 3); the head. K2 takes what the JAX
    package runs through ``models.matmul``: attention's 4 projections,
    MLA's ``w_dq``, ``w_dkv``, ``w_kr`` and ``wo``, the MLPs (the shared
    one too) and a token head -- not the codes heads' einsum, not the
    recurrent and xLSTM blocks' bare products."""
    kv_blocks = -(-seq // acfg.attn_block_k)
    fwd, dec, k2 = 1, 1, 0 if acfg.inputs == "codes" else 1
    for spec in acfg.block_specs:
        mixer, _, ffn = spec.partition("+")
        if mixer == "attn":
            f, d, k = 4 + 2 * kv_blocks, 6, 4
        elif mixer == "local":
            f, d, k = 6, 6, 4
        elif mixer == "mla":
            q = 2 if acfg.mla.q_lora_rank else 1
            f, d, k = q + 5 + 2 * kv_blocks, q + 8, q + 2
        elif mixer == "rglru":
            f, d, k = 5, 6, 0
        elif mixer == "mlstm":
            f, d, k = 8 + 5 * -(-seq // acfg.xlstm.chunk), 11, 0
        else:                                       # slstm
            f, d, k = 3 + seq, 5, 0
        if ffn == "mlp":
            n = 3 if acfg.mlp_gated else 2
            f, d, k = f + n, d + n, k + n
        elif ffn == "moe":
            n = 3 if acfg.moe.num_shared else 0
            f, d, k = f + 6 + n, d + 6 + n, k + n
        fwd, dec, k2 = fwd + f, dec + d, k2 + k
    return fwd, dec, k2


def zoo_shapes(acfg) -> dict:
    """The distinct ``(K, N)`` of a decode step's K2 launches."""
    d = acfg.d_model
    mixers = {s.partition("+")[0] for s in acfg.block_specs}
    ffns = {s.partition("+")[2] for s in acfg.block_specs}
    shapes = {}
    if mixers & {"attn", "local"}:
        q, kv = acfg.n_heads * acfg.hd, acfg.n_kv_heads * acfg.hd
        shapes |= {"wq": (d, q), "wk wv": (d, kv), "wo": (q, d)}
    if "mla" in mixers:
        m = acfg.mla
        if m.q_lora_rank:
            shapes["w_dq"] = (d, m.q_lora_rank)
        shapes |= {"w_dkv": (d, m.kv_lora_rank),
                   "w_kr": (d, m.qk_rope_head_dim),
                   "mla wo": (acfg.n_heads * m.v_head_dim, d)}
    if "mlp" in ffns:
        shapes |= {"ffn up gate": (d, acfg.d_ff), "ffn down": (acfg.d_ff, d)}
    if "moe" in ffns and acfg.moe.num_shared:
        f = acfg.moe.shared_ff or acfg.moe.expert_ff * acfg.moe.num_shared
        shapes |= {"shared up gate": (d, f), "shared down": (f, d)}
    if acfg.inputs != "codes":
        shapes["lm head"] = (d, acfg.vocab)
    out = {}
    for name, kn in shapes.items():    # wq and wo share a shape when q = d
        out.setdefault(kn, []).append(name)
    return {" ".join(v): k for k, v in out.items()}


def phase_zoo() -> dict:
    """The archs of the LM zoo at their published widths (:data:`ZOO`,
    random float32 masters from seed 0 run in bf16), through
    ``trace_arch(..., smoke=False)``: the forward at batch 2, seq 16 and
    3 decode steps after a prefill. Every recorded call is counted with
    the kernels and with every plain version, and the two captures must
    hold bitwise the same counters at every site; the sites, K1's launches
    (twice a call) and K2's (once a decode-step matmul it takes) must be
    the counts :func:`zoo_sites` makes per mixer. Then 3 greedy decode
    steps after a prefill with ``backend="auto"`` and ``"ref"`` fed the
    same inputs: the picks (per codebook for MusicGen) must be equal, or
    part only at a top-2 tie (:func:`tie_limit`). K2 at each decode shape
    (:func:`zoo_shapes`) against its plain version within ``PRODUCT_TOL``,
    and timed beside ``torch.matmul`` (:func:`zoo_k2`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.models import lm
    from repro_torch.trace import sweep as sw
    from repro_torch.trace.capture import TraceCapture

    class Twin(TraceCapture):
        """A capture that also records every call into a capture with
        every plain version."""

        def __init__(self, cfg, ref_cfg):
            super().__init__(cfg)
            self.ref = TraceCapture(ref_cfg)
            self.calls = 0

        def record(self, site):
            self.calls += 1
            super().record(site)
            self.ref.record(site)

    cfg = sw.make_capture_config()
    ref_cfg = dataclasses.replace(cfg, monitor=dataclasses.replace(
        cfg.monitor, backend="ref"))
    counted = (k1.fused_counters_cuda, kz.gated_row_matmul_cuda)
    out = {}
    for arch, layers in ZOO:
        t_arch = time.perf_counter()
        full = get_config(arch)
        acfg = full.with_(n_layers=layers)
        cut = ("none" if layers == full.n_layers else
               f"depth {layers} of {full.n_layers} layers")
        gen = torch.Generator(device="cuda").manual_seed(0)
        with torch.no_grad():
            params = lm.init_model(acfg, gen)
        n_params = sum(t.numel() for t in _leaves(params))
        n_fwd, n_dec, k2_step = zoo_sites(acfg)
        res = {"layers": layers, "of_layers": full.n_layers, "cut": cut,
               "params": n_params, "sites": n_fwd, "decode_sites": n_dec}
        for mode in ("forward", "decode"):
            steps = ZOO_DECODE_STEPS if mode == "decode" else 1
            n_sites = n_dec if mode == "decode" else n_fwd
            torch.cuda.synchronize()
            for fn in counted:
                fn.launches = 0
            cap = Twin(cfg, ref_cfg)
            t0 = time.perf_counter()
            rep = sw.trace_arch(arch, mode, batch=2, seq=ZOO_SEQ,
                                decode_steps=steps, smoke=False,
                                capture=cap, params=params,
                                arch_config=acfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
            if (len(rep.sites) != n_sites
                    or any(s.calls != steps for s in rep.sites)
                    or cap.calls != n_sites * steps):
                raise AssertionError(
                    f"zoo {arch} {mode}: {len(rep.sites)} sites, calls "
                    f"{sorted({s.calls for s in rep.sites})}; expected "
                    f"{n_sites}, {steps}")
            want_k2 = k2_step * steps if mode == "decode" else 0
            if (launches["fused_counters_cuda"] != 2 * cap.calls
                    or launches["gated_row_matmul_cuda"] != want_k2):
                raise AssertionError(f"zoo {arch} {mode}: launches "
                                     f"{launches} for {cap.calls} calls, "
                                     f"expected K2 {want_k2}")
            for name, acc in cap.sites.items():
                r = cap.ref.sites[name]
                if (r.counters != acc.counters or r.zf_sum != acc.zf_sum
                        or r.calls != acc.calls):
                    raise AssertionError(
                        f"zoo {arch} {mode} {name}: counters with the "
                        f"kernels differ from the plain versions'")
            sm = rep.summary()
            if not (0.0 < sm["streaming_saving"] < 1.0
                    and 0.0 < sm["streaming_share"] < 1.0):
                raise AssertionError(f"zoo {arch} {mode}: implausible {sm}")
            res[mode] = {"sites": n_sites, "calls": cap.calls,
                         "wall_s": wall, "launches": launches,
                         "streaming_saving": sm["streaming_saving"],
                         "total_saving": sm["total_saving"],
                         "mean_zero_fraction": sm["mean_zero_fraction"]}
            log(f"zoo {arch} {mode} (full width, cut: {cut}; "
                f"{n_params / 1e9:.2f} B parameters): {n_sites} sites, "
                f"{cap.calls} calls, wall {wall:.3f} s with the plain "
                f"capture beside, launches {json.dumps(launches)}; "
                f"streaming saving {sm['streaming_saving']!r}, total "
                f"{sm['total_saving']!r}; counters with the kernels "
                f"bitwise equal to the plain versions' at every site")
        res["greedy"] = zoo_greedy(acfg, params)
        res["k2"] = zoo_k2(acfg)
        res["wall_s"] = time.perf_counter() - t_arch
        out[arch] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _clone(tree):
    """A copy of a decode state (tensors in nested lists and tuples)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def tie_limit(top: float) -> float:
    """The top-2 logit margin under which two runs' greedy picks may part:
    ``LOGIT_TIE``, or two bf16 units in the last place at the top logit's
    magnitude where that is more (a tied head's logits pass 64)."""
    ulp = 2.0 ** (np.floor(np.log2(max(abs(top), 1e-30))) - 7)
    return max(LOGIT_TIE, 2 * ulp)


def zoo_greedy(acfg, params) -> dict:
    """A prefill of batch 2, seq 16, then :data:`ZOO_DECODE_STEPS` decode
    steps with the kernels (``"auto"``) and with the plain versions
    (``"ref"``), both fed the plain run's picks (per codebook for codes
    archs; embeds archs the JAX package's decode embeds): the kernels'
    picks equal, or parted only where the plain run's top two logits lie
    under :func:`tie_limit` apart."""
    from repro_torch.models import lm
    from repro_torch.trace import sweep as sw

    seq = ZOO_SEQ
    with torch.no_grad():
        weights = lm.compute_weights(params, acfg)
        inputs, positions = lm.model_input(
            acfg, sw.model_inputs(acfg, 2, seq, 0, "cuda"))
        prefill = lm.make_prefill_step(acfg, seq + ZOO_DECODE_STEPS)
        logits, states = prefill(weights, inputs, positions)
        runs = {b: (_clone(states), lm.make_decode_step(acfg, b))
                for b in ("auto", "ref")}
        pick = logits.argmax(-1)                      # [B] or [B, K]
        picks, ties, err = {"auto": [], "ref": []}, [], 0.0
        for t in range(ZOO_DECODE_STEPS):
            pos = torch.full((2, 1), seq + t, device="cuda")
            if acfg.inputs == "embeds":
                step = lm.model_input(acfg, sw.decode_inputs(
                    acfg, 2, seq + t, 0, "cuda"))
            else:
                step = (pick[..., None], pos)
            out = {b: fn(weights, st, *step) for b, (st, fn) in runs.items()}
            err = max(err, float((out["auto"] - out["ref"]).abs().max()))
            for b in out:
                picks[b].append(out[b].argmax(-1).tolist())
            flat = {b: o.reshape(-1, o.shape[-1]) for b, o in out.items()}
            top2 = flat["ref"].topk(2, dim=-1).values
            got, want = (flat[b].argmax(-1).tolist() for b in ("auto", "ref"))
            for i, (a, r) in enumerate(zip(got, want)):
                if a != r:
                    margin = float(top2[i, 0] - top2[i, 1])
                    if not margin < tie_limit(float(top2[i, 0])):
                        raise AssertionError(
                            f"zoo {acfg.name}: step {t} pick {i}: {a} with "
                            f"the kernels, {r} plain (margin {margin!r})")
                    ties.append(margin)
            pick = out["ref"].argmax(-1)
        del weights, runs
    log(f"zoo {acfg.name} greedy: {ZOO_DECODE_STEPS} decode steps, picks "
        f"with the kernels {picks['auto']}, plain {picks['ref']} "
        f"({len(ties)} parted at a tie, the plain run's top-2 margins "
        f"{ties}); max |logit auto - ref| {err!r}")
    return {"picks_auto": picks["auto"], "picks_ref": picks["ref"],
            "ties": ties, "max_logit_diff": err}


def zoo_k2(acfg) -> dict:
    """K2 at each decode shape of the arch (2 rows, bf16): held against
    its plain version within ``PRODUCT_TOL`` on operands with a gated
    row, then timed on live rows beside its plain version and
    ``torch.matmul``, with its bound. By CUDA events over 20 calls, not
    the profiler: the script's profiles are many already, and one more
    batch of them before the K1 shape timings left CUPTI delivering no
    device events there in one run."""
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.kernels.zvg_matmul import ref as zref

    M = 2
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for name, (K, N) in zoo_shapes(acfg).items():
        x, w = decode_operands(M, K, N, torch.bfloat16, gen)
        err = check_product(kz.gated_row_matmul_cuda(x, w),
                            zref.gated_row_matmul_ref(x, w), x, w,
                            f"K2 {acfg.name} {name} {M}x{K}x{N}")
        x = torch.randn(M, K, generator=gen, device="cuda").to(
            torch.bfloat16)
        t = {"ms": time_ms(lambda: kz.gated_row_matmul_cuda(x, w), 20),
             "plain_ms": time_ms(lambda: zref.gated_row_matmul_ref(x, w),
                                 20),
             "library_ms": time_ms(lambda: torch.matmul(x, w), 20),
             "bound_ms": max(2 * (M * K + K * N + M * N) / HBM_BYTES_PER_S,
                             2 * M * K * N / BF16_OPS_PER_S) * 1e3,
             "max_abs_err": err}
        out[f"{name} {M}x{K}x{N}"] = t
        log(f"gated_row_matmul {acfg.name} {name} {M}x{K}x{N}: within "
            f"tolerance of the plain version (max |kernel - plain| "
            f"{err!r}); ms by CUDA events: kernel {t['ms']:.4f}, plain "
            f"{t['plain_ms']:.4f}, torch.matmul {t['library_ms']:.4f}, "
            f"bound {t['bound_ms']:.5f}")
        del x, w
    return out


#: phase_zoo_serving: the slot engine with power accounting on the new
#: token archs at their published widths -- MiniCPM3-4B whole (MLA, right-
#: padded buckets) and RecurrentGemma-9B cut to 14 of 38 layers (RG-LRU
#: and local attention, prefilled at the exact prompt length): 4 greedy
#: requests (prompts of 16-64 tokens from ``default_rng(2)``) through 2
#: slots, 16 new tokens each
ZOO_SERVING = (("minicpm3-4b", 62), ("recurrentgemma-9b", 14))
ZOO_SERVE_REQUESTS = 4
ZOO_SERVE_SLOTS = 2
ZOO_SERVE_NEW = 16
ZOO_SERVE_CACHE = 128


def zoo_launches(zoo_serving: dict, kernel: str) -> dict:
    """One kernel's launches in each run of :func:`phase_zoo_serving`
    with the kernels."""
    return {k.rsplit(" ", 1)[0]: v["launches"][kernel]
            for k, v in zoo_serving.items() if k.endswith(" auto")}


def telemetry_launches(telemetry: dict, kernel: str) -> dict:
    """One kernel's launches in each run of :func:`phase_telemetry` with
    the kernels."""
    return {k.rsplit(" ", 1)[0]: v["launches"][kernel]
            for k, v in telemetry.items() if k.endswith(" auto")}


def zoo_serving_prompts(vocab: int) -> list:
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, int(n)).tolist()
            for n in rng.integers(16, 65, ZOO_SERVE_REQUESTS)]


#: the zoo archs also served paged (pages of 16, 2 rows): an ample pool,
#: then prompts sharing a ``ZOO_SHARED``-token prefix through the prefix
#: cache, each with the kernels and with every plain version
ZOO_PAGED = ("minicpm3-4b",)
ZOO_PAGE = 16
ZOO_SHARED = 32


def zoo_shared_prompts(vocab: int, prompts: list) -> list:
    """The zoo prompts behind one shared ``ZOO_SHARED``-token prefix
    (``default_rng(3)``)."""
    shared = np.random.default_rng(3).integers(0, vocab, ZOO_SHARED).tolist()
    return [shared + p for p in prompts]


def zoo_serve(params, acfg, prompts, backend: str, counted, paging=None,
              record: bool = False):
    """Serve ``prompts`` (greedy, :data:`ZOO_SERVE_NEW` tokens each) with
    power accounting through 2 slots (or rows, with ``paging``): ``(eng,
    {uid: request}, wall s, launches by wrapper name, gaps, (bucket,
    prompt) prefill lengths)``, the launches of the run alone."""
    from repro_torch.serve import ServeConfig, ServeEngine

    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    eng = ServeEngine(params, acfg, ServeConfig(
        max_slots=ZOO_SERVE_SLOTS, cache_len=ZOO_SERVE_CACHE,
        power_monitor=True, kernel_backend=backend, paging=paging))
    gaps = record_gaps(eng) if record else {}
    lengths = []
    prefill = eng._prefill

    def recording_prefill(weights, toks, length, prefill=prefill,
                          lengths=lengths):
        lengths.append((toks.shape[1], length))
        return prefill(weights, toks, length)
    eng._prefill = recording_prefill
    for p in prompts:
        eng.submit(p, max_new_tokens=ZOO_SERVE_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {r.uid: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (eng, done, wall, {fn.__name__: fn.launches for fn in counted},
            gaps, lengths)


def phase_zoo_serving() -> dict:
    """:data:`ZOO_SERVING` through the slot engine with power accounting,
    with ``kernel_backend="auto"`` (K1 in the prefill accounting, K2 in
    every decode matmul the JAX package runs through its backend, K3 in
    each sampled step's accounting) and ``"ref"`` (every plain version):
    greedy tokens equal (or parted at a tie, :func:`compare_runs`) and
    every request's energies within rtol 1e-6; K2's launches the decode
    steps times :func:`zoo_sites`' count, K3's two a sampled step (the
    two monitored weights); the recurrent arch's prompts prefilled at
    their exact lengths. The archs of :data:`ZOO_PAGED` then serve paged
    (latent caches in pages of :data:`ZOO_PAGE`, gathered for the
    absorbed decode, no K4): with an ample pool they must give the slot
    run's tokens and energies, and so must their plain run; prompts
    behind a shared prefix must hit the prefix cache and give their own
    plain run's tokens and energies."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.models import lm
    from repro_torch.serve import PagingConfig

    counted = (k1.fused_counters_cuda, kz.gated_row_matmul_cuda,
               kz.fused_matmul_counters_cuda, kz.fused_paged_attention_cuda)
    out = {}
    for arch, layers in ZOO_SERVING:
        full = get_config(arch)
        acfg = full.with_(n_layers=layers)
        with torch.no_grad():
            params = lm.init_model(
                acfg, torch.Generator(device="cuda").manual_seed(0))
        prompts = zoo_serving_prompts(acfg.vocab)
        k2_step = zoo_sites(acfg)[2]

        def check(label, backend, eng, done, launches, n_prompts):
            steps = eng.stats["decode_steps"]
            for r in done.values():
                if (r.finish_reason != "length"
                        or len(r.generated) != ZOO_SERVE_NEW
                        or not 0 < r.power.saving_total < 1):
                    raise AssertionError(f"{label} request {r.uid}: "
                                         f"{r.finish_reason}, "
                                         f"{len(r.generated)} tokens, "
                                         f"{r.power.summary()}")
            if len(done) != n_prompts:
                raise AssertionError(f"{label}: {len(done)} retired")
            want = ({"gated_row_matmul_cuda": k2_step * steps,
                     "fused_matmul_counters_cuda": 2 * steps,
                     "fused_paged_attention_cuda": 0}
                    if backend == "auto" else
                    {"gated_row_matmul_cuda": 0,
                     "fused_matmul_counters_cuda": 0,
                     "fused_paged_attention_cuda": 0})
            if ({k: launches[k] for k in want} != want
                    or (launches["fused_counters_cuda"] > 0)
                    != (backend == "auto")):
                raise AssertionError(f"{label}: launches {launches}, "
                                     f"expected {want}")

        def record(key, eng, wall, launches, lengths, **extra):
            tok_s = eng.stats["tokens"] / wall
            out[key] = {
                "layers": layers, "of_layers": full.n_layers,
                "decode_steps": eng.stats["decode_steps"],
                "tokens": eng.stats["tokens"], "wall_s": wall,
                "tokens_per_s": tok_s, "launches": launches,
                "prefill_lengths": lengths, **extra}
            return tok_s

        runs = {}
        for backend in ("auto", "ref"):
            eng, done, wall, launches, gaps, lengths = zoo_serve(
                params, acfg, prompts, backend, counted,
                record=backend == "ref")
            label = f"{arch} {backend}"
            check(label, backend, eng, done, launches, len(prompts))
            exact = all(b == n for b, n in lengths)
            if not eng._pad_safe and not exact:
                raise AssertionError(f"{arch}: prefill padded {lengths}")
            runs[backend] = (eng, done, gaps)
            tok_s = record(label, eng, wall, launches, lengths,
                           exact_length_prefill=exact)
            log(f"zoo serving {arch} (full width, depth {layers} of "
                f"{full.n_layers}, kernel_backend={backend!r}, "
                f"{ZOO_SERVE_SLOTS} slots, {ZOO_SERVE_REQUESTS} requests x "
                f"{ZOO_SERVE_NEW} tokens): {eng.stats['decode_steps']} "
                f"decode steps, {eng.stats['tokens']} tokens in "
                f"{wall:.3f} s ({tok_s:.1f} tok/s incl. prefill and "
                f"accounting); launches {json.dumps(launches)}; prefill "
                f"(bucket, prompt) lengths {lengths}"
                + (" -- at the exact prompt length (not pad-safe)"
                   if not eng._pad_safe else ""))
        (eng, done, _), (ref_eng, ref_done, gaps) = runs["auto"], runs["ref"]
        equal = compare_runs(done, ref_done, gaps, (), f"{arch}'s plain run")
        if equal == len(done):
            assert_reports_close(eng, ref_eng, f"{arch}'s plain run's")
        out[f"{arch} equal"] = equal
        if arch in ZOO_PAGED:
            ample = PagingConfig(
                page_size=ZOO_PAGE, max_rows=ZOO_SERVE_SLOTS,
                num_pages=ZOO_SERVE_SLOTS * ZOO_SERVE_CACHE // ZOO_PAGE + 1)
            shared = PagingConfig(
                page_size=ZOO_PAGE, max_rows=ZOO_SERVE_SLOTS,
                num_pages=ZOO_SERVE_SLOTS * ZOO_SERVE_CACHE // ZOO_PAGE + 1,
                prefix_cache=True)
            shared_prompts = zoo_shared_prompts(acfg.vocab, prompts)
            paged = {}
            for name, paging, reqs in (("paged", ample, prompts),
                                       ("paged prefix", shared,
                                        shared_prompts)):
                for backend in ("auto", "ref"):
                    peng, pdone, wall, launches, pgaps, lengths = zoo_serve(
                        params, acfg, reqs, backend, counted, paging,
                        record=True)
                    label = f"{arch} {name} {backend}"
                    check(label, backend, peng, pdone, launches, len(reqs))
                    st = peng.stats
                    c = peng.cache
                    cached = len(peng.prefix) if peng.prefix is not None \
                        else 0
                    if c.n_live or c.n_free_pages + cached != \
                            c.num_pages - 1:
                        raise AssertionError(f"{label}: pages not "
                                             f"conserved")
                    if (name == "paged prefix"
                            and not st["prefix_hit_requests"] > 0):
                        raise AssertionError(f"{label}: no prefix hit")
                    paged[(name, backend)] = (peng, pdone, pgaps)
                    tok_s = record(label, peng, wall, launches, lengths,
                                   prefix_hit_requests=st[
                                       "prefix_hit_requests"],
                                   peak_admitted=st["peak_admitted"])
                    log(f"zoo serving {arch} paged (pages of {ZOO_PAGE}, "
                        f"{c.num_pages - 1} usable, {ZOO_SERVE_SLOTS} rows"
                        + (f", a {ZOO_SHARED}-token shared prefix, prefix "
                           f"cache" if name == "paged prefix" else "")
                        + f", kernel_backend={backend!r}): "
                        f"{st['decode_steps']} decode steps, {st['tokens']} "
                        f"tokens in {wall:.3f} s ({tok_s:.1f} tok/s); "
                        f"launches {json.dumps(launches)} (no K4: MLA "
                        f"gathers its latent pages); prefix hits "
                        f"{st['prefix_hit_requests']}")
            peng, pdone, pgaps = paged[("paged", "auto")]
            eq = compare_runs(done, pdone, pgaps, (),
                              f"{arch}'s ample paged run")
            if eq == len(done):
                assert_reports_close(eng, peng,
                                     f"{arch}'s ample paged run's")
            out[f"{arch} paged equal"] = eq
            for name in ("paged", "paged prefix"):
                (peng, pdone, _), (reng, rdone, rgaps) = (
                    paged[(name, "auto")], paged[(name, "ref")])
                eq = compare_runs(pdone, rdone, rgaps, (),
                                  f"{arch}'s plain {name} run")
                if eq == len(pdone):
                    assert_reports_close(peng, reng,
                                         f"{arch}'s plain {name} run's")
                out[f"{arch} {name} ref equal"] = eq
            del paged, peng, reng
        del params, runs, eng, ref_eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


#: phase_train: Qwen1.5-0.5B at full width trained from seed 0 on
#: SyntheticLM (seed 0) at the JAX TrainConfig's batch and sequence, the
#: power monitor on every step and a whole-forward trace every
#: TRAIN_TRACE_EVERY steps; resume equivalence on the same widths cut to
#: TRAIN_RESUME_LAYERS layers (a full-depth checkpoint is ~5.6 GB)
TRAIN_STEPS = 8
TRAIN_BATCH = 8
TRAIN_SEQ = 256
TRAIN_LR = 1e-3
TRAIN_WARMUP = 2
TRAIN_TRACE_EVERY = 4
TRAIN_RESUME_LAYERS = 2
TRAIN_RESUME_STEPS = 6
#: tests/test_runtime.py's tolerance for resumed against straight runs
TRAIN_RESUME_RTOL = 1e-4
#: gradient-sized float32 tensors for compress_with_feedback, card
#: against CPU: Qwen1.5-0.5B's embedding, FFN up and down, a norm scale
TRAIN_COMPRESS_SHAPES = ((151936, 1024), (1024, 2816), (2816, 1024),
                         (1024,))


def phase_train() -> dict:
    """The training path (``repro_torch.launch.train``) on the card.

    (a) ``train()`` of Qwen1.5-0.5B at full width for TRAIN_STEPS steps
    with the power monitor on and a trace every TRAIN_TRACE_EVERY steps.
    Every loss and ``grad_norm`` must be finite and the last loss below
    step 0's; at every step the monitor's metrics with K1 must equal,
    within rtol 1e-6, the plain counters' on the same updated
    params and batch; at each traced step every site's counters from K1
    must be bitwise those of a plain capture of the same recorded
    sites; K1's launches over the run are counted. Then the final params
    and moments are saved once (asynchronously) and restored into fresh
    tensors, bitwise.
    (b) Resume equivalence at TRAIN_RESUME_LAYERS layers: two straight
    runs of TRAIN_RESUME_STEPS steps (how far the card's own runs part)
    and a run stopped at half and resumed from its checkpoint, whose
    final loss must be within TRAIN_RESUME_RTOL of the first straight
    run's.
    (c) ``compress_with_feedback`` on TRAIN_COMPRESS_SHAPES, on the card
    and on the CPU: bitwise (fault 7's rule: it divides by tensors).
    """
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    from repro_torch.optim.adamw import compress_with_feedback
    from repro_torch.trace import sweep as sw
    from repro_torch.trace.capture import TraceCapture
    from repro_torch.tree import tree_leaves, tree_map

    class Recording(TraceCapture):
        """A capture that keeps every site it records."""

        def __init__(self, cfg):
            super().__init__(cfg)
            self.recorded = []

        def record(self, site):
            self.recorded.append(site)
            super().record(site)

    cap_cfg = sw.make_capture_config()
    ref_cfg = dataclasses.replace(cap_cfg, monitor=dataclasses.replace(
        cap_cfg.monitor, backend="ref"))
    out = {}
    seen = {"step_ms": [], "monitor_ms": [], "trace_s": [], "extra": 0}
    build, power_trace = tr.build, tr._power_trace

    def checked_build(tc):
        cfg, opt, step_fn = build(tc)

        def step(params, opt_state, batch, i):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch, i)
            torch.cuda.synchronize()
            seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
            seen["state"] = (params, opt_state)
            if tc.power_monitor:
                n = k1.fused_counters_cuda.launches
                t0 = time.perf_counter()
                again = lm._monitor_metrics(params, cfg, batch)
                torch.cuda.synchronize()
                seen["monitor_ms"].append((time.perf_counter() - t0) * 1e3)
                seen["extra"] += k1.fused_counters_cuda.launches - n
                plain = lm._monitor_metrics(params, cfg, batch, "ref")
                power = {k: v for k, v in m.items()
                         if k.startswith("power/")}
                if not (sorted(power) == sorted(again) == sorted(plain)):
                    raise AssertionError(f"train step {i}: monitor keys "
                                         f"{sorted(power)} {sorted(plain)}")
                for k, v in power.items():
                    if float(v) != float(again[k]):
                        raise AssertionError(f"train step {i} {k}: the "
                                             f"monitor is not repeatable")
                    assert_close(float(v), float(plain[k]),
                                 f"train step {i} {k} (K1 against plain)")
            return params, opt_state, m

        return cfg, opt, step

    def checked_trace(tc, cfg, params, batch, i, capture=None):
        cap = Recording(cap_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg = power_trace(tc, cfg, params, batch, i, capture=cap)
        torch.cuda.synchronize()
        seen["trace_s"].append(time.perf_counter() - t0)
        ref = TraceCapture(ref_cfg)
        for site in cap.recorded:
            ref.record(site)
        for name, acc in cap.sites.items():
            r = ref.sites[name]
            if (r.counters != acc.counters or r.zf_sum != acc.zf_sum
                    or r.calls != acc.calls):
                raise AssertionError(f"train trace at step {i}, {name}: "
                                     f"counters with K1 differ from the "
                                     f"plain versions'")
        seen.setdefault("trace_calls", []).append(len(cap.recorded))
        return agg

    tr.build, tr._power_trace = checked_build, checked_trace
    tmp = tempfile.mkdtemp(prefix="train_", dir=ROOT / "build")
    try:
        # (a) the main path at full width
        tc = tr.TrainConfig(arch=SERVE_ARCH, steps=TRAIN_STEPS,
                            seq=TRAIN_SEQ, batch=TRAIN_BATCH, lr=TRAIN_LR,
                            warmup=TRAIN_WARMUP, power_monitor=True,
                            power_trace_every=TRAIN_TRACE_EVERY)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.fused_counters_cuda.launches = 0
        t0 = time.perf_counter()
        run = tr.train(tc)
        wall = time.perf_counter() - t0
        launches = k1.fused_counters_cuda.launches - seen["extra"]
        hist = run["history"]
        losses = [h["loss"] for h in hist]
        norms = [h["grad_norm"] for h in hist]
        if len(hist) != TRAIN_STEPS or not all(
                np.isfinite(losses + norms)):
            raise AssertionError(f"train: losses {losses}, grad norms "
                                 f"{norms}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train: the loss did not fall: {losses}")
        traced = [t["step"] for t in run["power_traces"]]
        if traced != list(range(0, TRAIN_STEPS, TRAIN_TRACE_EVERY)):
            raise AssertionError(f"train: traces at steps {traced}")
        want = 2 * TRAIN_STEPS + 2 * sum(seen["trace_calls"])
        if launches != want:
            raise AssertionError(f"train: K1 launches {launches}, expected "
                                 f"{want} (2 a monitored step, 2 a traced "
                                 f"call)")
        peak = torch.cuda.max_memory_allocated()
        params, opt_state = seen["state"]
        ck = Checkpointer(tmp, keep=1, async_save=True)
        t0 = time.perf_counter()
        ck.save(TRAIN_STEPS - 1, (params, opt_state))
        handed = time.perf_counter() - t0
        ck.wait()
        save_s = time.perf_counter() - t0
        fresh = tree_map(torch.empty_like, (params, opt_state))
        t0 = time.perf_counter()
        restored = ck.restore(TRAIN_STEPS - 1, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for a, b in zip(tree_leaves(restored), tree_leaves(
                (params, opt_state))):
            if not (a.device == b.device and torch.equal(a, b)):
                raise AssertionError("train: the restored checkpoint is "
                                     "not the saved state")
        n_params = sum(p.numel() for p in tree_leaves(params))
        del restored, fresh, params, opt_state, seen["state"], ck
        shutil.rmtree(tmp, ignore_errors=True)
        warm = sorted(seen["step_ms"][1:])
        out["a"] = {
            "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "params": n_params, "wall_s": wall,
            "step_ms": seen["step_ms"],
            "warm_median_step_ms": warm[len(warm) // 2],
            "trainer_median_step_ms": run["median_step_time"] * 1e3,
            "monitor_ms": seen["monitor_ms"], "trace_s": seen["trace_s"],
            "trace_calls": seen["trace_calls"],
            "k1_launches": launches, "max_memory_gib": peak / 2 ** 30,
            "save_s": save_s, "save_handed_back_s": handed,
            "restore_s": restore_s, "loss": losses, "grad_norm": norms,
            "power": {k: v for k, v in hist[-1].items()
                      if k.startswith("power/")},
            "traces": run["power_traces"]}
        log(f"train (a) {SERVE_ARCH} at full width ({n_params} params), "
            f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps in "
            f"{wall:.1f} s: step ms {[round(t, 1) for t in seen['step_ms']]}"
            f" (warm median {out['a']['warm_median_step_ms']:.1f}); loss "
            f"{losses[0]!r} at step 0 -> {losses[-1]!r} at step "
            f"{TRAIN_STEPS - 1}; monitor (K1) "
            f"{[round(t, 2) for t in seen['monitor_ms']]} ms a step, "
            f"equal to the plain counters' within rtol 1e-6; "
            f"traces at {traced}: {seen['trace_calls']} calls in "
            f"{[round(t, 2) for t in seen['trace_s']]} s, counters with K1 "
            f"bitwise the plain versions' at every site; K1 launches "
            f"{launches}; peak memory {peak / 2 ** 30:.2f} GiB; checkpoint "
            f"saved in {save_s:.1f} s (handed back in {handed:.1f} s), "
            f"restored in {restore_s:.1f} s, bitwise")

        # (b) resume equivalence, cut in depth
        tr.build, tr._power_trace = build, power_trace
        get_config = tr.get_config
        tr.get_config = lambda arch, smoke=False: get_config(
            arch, smoke).with_(n_layers=TRAIN_RESUME_LAYERS)
        kw = dict(arch=SERVE_ARCH, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                  lr=TRAIN_LR, warmup=TRAIN_WARMUP, ckpt_every=1000)
        t0 = time.perf_counter()
        straight = [tr.train(tr.TrainConfig(**kw, steps=TRAIN_RESUME_STEPS))
                    for _ in range(2)]
        tr.train(tr.TrainConfig(**kw, steps=TRAIN_RESUME_STEPS // 2,
                                ckpt_dir=tmp))
        resumed = tr.train(tr.TrainConfig(**kw, steps=TRAIN_RESUME_STEPS,
                                          ckpt_dir=tmp))
        resume_s = time.perf_counter() - t0
        shutil.rmtree(tmp, ignore_errors=True)
        want = straight[0]["final_loss"]
        first = resumed["history"][0]["step"]
        if first != TRAIN_RESUME_STEPS // 2:
            raise AssertionError(f"train resume: started at step {first}")
        spread = abs(straight[1]["final_loss"] - want) / abs(want)
        apart = abs(resumed["final_loss"] - want) / abs(want)
        if apart > TRAIN_RESUME_RTOL:
            raise AssertionError(
                f"train resume: final loss {resumed['final_loss']!r} "
                f"against {want!r} straight ({apart:.3g} apart; two "
                f"straight runs {spread:.3g})")
        out["b"] = {"layers": TRAIN_RESUME_LAYERS,
                    "steps": TRAIN_RESUME_STEPS, "wall_s": resume_s,
                    "straight_final_loss": [s["final_loss"]
                                            for s in straight],
                    "resumed_final_loss": resumed["final_loss"],
                    "straight_rel": spread, "resumed_rel": apart,
                    "bitwise": resumed["final_loss"] == want}
        log(f"train (b) {TRAIN_RESUME_LAYERS} of 24 layers, "
            f"{TRAIN_RESUME_STEPS} steps: straight final losses "
            f"{out['b']['straight_final_loss']} ({spread:.3g} apart), "
            f"stopped at {TRAIN_RESUME_STEPS // 2} and resumed "
            f"{resumed['final_loss']!r} ({apart:.3g} from the first; "
            f"bitwise: {out['b']['bitwise']}), {resume_s:.1f} s")
    finally:
        tr.build, tr._power_trace = build, power_trace
        if "get_config" in locals():
            tr.get_config = get_config
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) compress_with_feedback, card against CPU
    gen = torch.Generator().manual_seed(0)
    grads = {str(i): torch.randn(s, generator=gen) * 10.0 ** -(i % 3)
             for i, s in enumerate(TRAIN_COMPRESS_SHAPES)}
    err = {k: torch.randn(g.shape, generator=gen) * 1e-3
           for k, g in grads.items()}
    want = compress_with_feedback(grads, err)
    got = compress_with_feedback(
        {k: g.cuda() for k, g in grads.items()},
        {k: e.cuda() for k, e in err.items()})
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("compress_with_feedback: the card and the "
                                 "CPU differ")
    out["c"] = {"shapes": [list(s) for s in TRAIN_COMPRESS_SHAPES],
                "bitwise": True}
    log(f"train (c) compress_with_feedback on "
        f"{[list(s) for s in TRAIN_COMPRESS_SHAPES]}: card and CPU bitwise")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_trace_busy(traces: dict) -> None:
    """Each trace of :data:`TRACE_RUNS` once more, warm, under the
    profiler: its kernels' device time and the device's busy share of
    the wall time, added to ``traces``. It runs after every timing phase:
    after profiles this large, CUPTI has delivered no device events to the
    next small ones (the K1 shape timings)."""
    from repro_torch.trace import sweep as sw
    from repro_torch.trace.capture import TraceCapture

    cfg = sw.make_capture_config()
    for label in TRACE_RUNS:
        prof = profile_once(f"trace {label}",
                            lambda: trace_run(label, TraceCapture(cfg)))
        traces[label]["profiled"] = prof
        traces[label]["busy_share"] = prof and (prof["busy_ms"]
                                                / prof["wall_ms"])


def phase_train_busy(train: dict) -> None:
    """Where a warm train step of phase_train (a) spends its time, from
    the initial state of its model and its step-1 batch: the loss with
    its backward, the optimiser's update with the masters' add, the
    monitor and the whole step (K1 included), each by CUDA events; then
    the whole step under the profiler (device time by kernel, the busy
    share of its wall time). Added to ``train["a"]``; it runs after every
    timing phase, as :func:`phase_trace_busy` does."""
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    tc = tr.TrainConfig(arch=SERVE_ARCH, steps=TRAIN_STEPS, seq=TRAIN_SEQ,
                        batch=TRAIN_BATCH, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                        power_monitor=True)
    cfg, opt, step_fn = tr.build(tc)
    params, opt_state = tr.init_state(cfg, opt, torch.device("cuda"),
                                      tc.seed)
    device = tree_leaves(params)[0].device
    batch = tr.batch_to(make_source(cfg, DataConfig(
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=tc.seed)).batch(1),
        device)
    step = torch.tensor(1, dtype=torch.int32, device=device)

    def loss_and_backward():
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = lm.loss_fn(tree_unflatten(params, leaves), cfg, batch)
        return tree_unflatten(params, torch.autograd.grad(loss, leaves))

    grads = loss_and_backward()

    def update():
        with torch.no_grad():
            updates, _ = opt.update(grads, opt_state, params, step)
            return tree_map(torch.add, params, updates)

    parts = {"loss_and_backward": loss_and_backward, "optimiser": update,
             "monitor": lambda: lm._monitor_metrics(params, cfg, batch),
             "step": lambda: step_fn(params, opt_state, batch, step)}
    ms = {k: time_ms(fn, 3) for k, fn in parts.items()}
    log("train step at full width by part (CUDA events): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in ms.items()))
    prof = profile_once("train step", parts["step"])
    train["a"]["step_parts_ms"] = ms
    train["a"]["profiled"] = prof
    train["a"]["busy_share"] = prof and prof["busy_ms"] / prof["wall_ms"]
    del params, opt_state, grads
    gc.collect()
    torch.cuda.empty_cache()


#: phase_bench: the suites of ``bench/run.py`` that no earlier phase
#: drives, run whole, and the three whose paths phase_sweep, phase_trace
#: and phase_telemetry drive, run with ``quick``
BENCH_SUITES = ("fig2_distributions", "bic_variants", "counter_kernels",
                "fig45_per_layer", "overall_savings", "overhead_scaling",
                "activity_reduction", "power_monitor_lm", "serve_kernels",
                "serve_paging", "serve_throughput")
BENCH_QUICK = ("design_sweep", "trace_full_model", "serve_online")
#: each benchmark artifact and the schema it must pass
BENCH_ARTIFACTS = {
    "serve_kernels": ("BENCH_kernels.json", "bench_kernels.schema.json"),
    "serve_paging": ("BENCH_serve.json", "bench_serve.schema.json")}


class _Tee:
    """A stdout that also keeps what it was given."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def bench_layers_equal(net: str, cached: dict, layers) -> None:
    """The benchmarks' cached analysis (the paper pair) against the main
    path's layers (the whole menu, whose first two designs are the
    pair): every field bitwise, but the selection and the designs the
    pair does not price."""
    if len(cached["layers"]) != len(layers):
        raise AssertionError(f"bench {net}: {len(cached['layers'])} layers, "
                             f"the main path {len(layers)}")
    for got, l in zip(cached["layers"], layers):
        want = vars(l)
        for k, v in want.items():
            if k == "selected":
                continue
            if k == "designs":
                v = {d: v[d] for d in got[k]}
            if got[k] != v:
                raise AssertionError(f"bench {net} {l.name}.{k}: {got[k]!r} "
                                     f"!= the main path's {v!r}")


def phase_bench(layers, mlayers) -> dict:
    """The port's benchmark drivers on the card through
    ``bench.run.run_suites``: :data:`BENCH_SUITES` whole, then
    :data:`BENCH_QUICK` with ``quick``, the CNN analysis cache pointed at
    a fresh temporary directory and the serving artifacts written there.
    No suite may fail; each of K1-K3 and K5-K7 must launch in the phase
    and K4 (the paged engine runs the plain route here, as in the JAX
    benchmarks) must not; the cached CNN analyses must equal
    ``run_main_path``'s layers bitwise; the fused counter pass must
    report integer equality; the artifacts must pass their schemas. The
    claim verdicts (C1-C5) and each suite's wall time are logged."""
    import contextlib
    import functools
    import tempfile

    from repro_torch.bench import common, run
    from repro_torch.kernels.bic_encode import kernel as k6
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.transitions import kernel as k5
    from repro_torch.kernels.zvg_matmul import kernel as kz

    counted = (k1.fused_counters_cuda, kz.gated_row_matmul_cuda,
               kz.fused_matmul_counters_cuda, kz.fused_paged_attention_cuda,
               k5.transitions_cuda, k6.bic_encode_cuda, kz.zvg_matmul_cuda)
    walls: dict[str, float] = {}
    by_suite: dict[str, dict] = {}

    def timed_suite(name, fn):
        """``fn`` with its wall time and its launches of each kernel."""
        def call(**kw):
            torch.cuda.synchronize()
            before = [f.launches for f in counted]
            t = time.perf_counter()
            try:
                return fn(**kw)
            finally:
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t
                by_suite[name] = {f.__name__: f.launches - n for f, n in
                                  zip(counted, before) if f.launches > n}
        return call

    saved = (common.RESULTS, dict(run.SUITES))
    tee = _Tee(sys.stdout)
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        tmp = Path(tmp)
        common.RESULTS = str(tmp)
        for name, (fn, quick) in saved[1].items():
            if name in BENCH_ARTIFACTS:
                fn = functools.partial(fn, emit_json=str(
                    tmp / BENCH_ARTIFACTS[name][0]))
            run.SUITES[name] = (timed_suite(name, fn), quick)
        for fn in counted:
            fn.launches = 0
        try:
            with contextlib.redirect_stdout(tee):
                fails = run.run_suites(list(BENCH_SUITES), device="cuda")
                fails += run.run_suites(list(BENCH_QUICK), quick=True,
                                        device="cuda")
        except SystemExit as e:
            raise AssertionError(f"bench: a suite exited: {e}") from e
        finally:
            common.RESULTS = saved[0]
            run.SUITES.clear()
            run.SUITES.update(saved[1])
        launches = {fn.__name__: fn.launches for fn in counted}
        if fails:
            raise AssertionError(f"bench: {fails} suite(s) failed")
        log(f"bench: {len(walls)} suites, launches {json.dumps(launches)}; "
            f"wall s {json.dumps({k: round(v, 3) for k, v in walls.items()})}"
            f"; launches by suite {json.dumps(by_suite)}")
        idle = [k for k, v in launches.items()
                if (v == 0) != (k == "fused_paged_attention_cuda")]
        if idle:
            raise AssertionError(f"bench launches {launches}: {idle} not as "
                                 f"expected (K4 none, every other kernel "
                                 f"some)")
        # serve_throughput's cells run the plain route but its fused one
        fused = by_suite["serve_throughput"]
        if not (fused.get("gated_row_matmul_cuda")
                and fused.get("fused_matmul_counters_cuda")):
            raise AssertionError(f"bench serve_throughput: launches {fused}: "
                                 f"its fused cell ran without K2 and K3")
        for net, ls in (("resnet50", layers), ("mobilenet", mlayers)):
            cache = tmp / f"cnn_{net}_1img_224px_cuda.json"
            bench_layers_equal(net, json.loads(cache.read_text()), ls)
        log("bench: the cached ResNet50 and MobileNetV1 analyses equal the "
            "main path's layers bitwise")
        for artifact, schema in BENCH_ARTIFACTS.values():
            rc = subprocess.run(
                [sys.executable, str(ROOT / "tools" / "check_bench_schema.py"),
                 "--schema", str(ROOT / "schemas" / schema),
                 str(tmp / artifact)],
                capture_output=True, text=True, timeout=120)
            if rc.returncode:
                raise AssertionError(f"bench {artifact}: {rc.stdout}"
                                     f"{rc.stderr}")
        log(f"bench: {', '.join(a for a, _ in BENCH_ARTIFACTS.values())} "
            f"pass their schemas")
    lines = tee.text().splitlines()
    if not any(l.startswith("fused_counter_pass,")
               and l.endswith("integer equality CONFIRMED") for l in lines):
        raise AssertionError("bench: the fused counter pass did not report "
                             "integer equality")
    verdicts = [l.strip("# ") for l in lines
                if any(c in l for c in (" C1 ", " C2 ", "C3:", "C4 ",
                                        "ordering ResNet50",
                                        "acceptance:"))]
    for v in verdicts:
        log(f"bench verdict: {v}")
    return {"launches": launches, "launches_by_suite": by_suite,
            "wall_s": walls, "verdicts": verdicts}


def phase_breakdown(net: str, designs) -> dict:
    """Where a warm run of the main path spends its wall time (host
    clock, synchronized after each part): the forward with operand
    capture, the counter passes with stream building and the lane sums'
    copies to the host, the float32 pricing on the host, the selection."""
    from repro_torch import design as D
    from repro_torch.apps.cnn import analysis, nets
    from repro_torch.core import systolic

    ((geom, precision), kw), = D.menu_args(designs).items()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = nets.synthetic_images(1, 224, seed=7, device="cuda")
    traces = nets.forward_with_traces(net, images, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    menus = [systolic.sa_design_report(*analysis.matmul_operands(t), geom,
                                       precision=precision, **kw)
             for t in traces]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for m in menus:
        D.evaluate(m, designs)
    t3 = time.perf_counter()
    layers = [analysis.analyze_trace(t, designs=designs) for t in traces]
    t4 = time.perf_counter()
    analysis.select_network(layers)
    t5 = time.perf_counter()
    out = {"forward_s": t1 - t0, "counters_s": t2 - t1, "pricing_s": t3 - t2,
           "analysis_s": t4 - t3, "selection_s": t5 - t4}
    log(f"{net} warm run breakdown: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    return out


# ------------------------------------------------ decode kernels (K2, K3)
def decode_operands(M: int, K: int, N: int, dtype, gen: torch.Generator):
    """Activations with a +0.0 row, a -0.0 row and a subnormal row among
    normal ones (as many as M allows), and fan-in-scaled weights."""
    x = torch.randn(M, K, generator=gen, device="cuda")
    w = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
    specials = (0.0, -0.0, 1e-39)       # 1e-39: float32 subnormal
    for r, v in zip(range(1, M, 2), specials):
        x[r] = v
    if dtype == torch.bfloat16:
        x, w = x.to(dtype), w.to(dtype)
        if M > 5:
            x[5] = 2.0 ** -133      # the smallest bfloat16 subnormal
    return x, w


def check_product(got: torch.Tensor, plain: torch.Tensor, x, w,
                  ctx: str) -> float:
    """Gated rows (all +0.0 words) bit-equal to the plain version's;
    every row within PRODUCT_TOL of the float32 product. Returns the
    largest |kernel - plain|."""
    from repro_torch.kernels.zvg_matmul.ref import row_is_live

    gated = ~row_is_live(x)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    if not torch.equal(got[gated].view(bits), plain[gated].view(bits)):
        raise AssertionError(f"{ctx}: gated rows differ from the plain "
                             f"version's")
    f32 = x.float() @ w.float()
    rel, acc = PRODUCT_TOL[got.dtype]
    # results below the smallest normal float32 may be flushed to zero
    bound = (rel * f32.abs() + acc * (x.float().abs() @ w.float().abs())
             + 2.0 ** -126)
    for name, out in (("kernel", got), ("plain version", plain)):
        excess = ((out.float() - f32).abs() - bound).max()
        if excess > 0:
            raise AssertionError(f"{ctx}: the {name} is {float(excess)!r} "
                                 f"outside the stated tolerance")
    return float((got.float() - plain.float()).abs().max())


def phase_decode_kernel_cases() -> tuple[float, float]:
    """K2 and K3 against their plain versions on the card. Returns the
    largest |kernel - plain| of each."""
    from repro_torch.core import bic
    from repro_torch.kernels.power_counters import CounterSpec
    from repro_torch.kernels.zvg_matmul import kernel, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    err2 = 0.0
    shapes = [(M, K, N) for M in (SERVE_SLOTS, PAGED_ROWS)
              for K, N in DECODE_SHAPES]
    shapes += [(m, k, n) for m in (1, 3, 7, 9) for k in (1, 63)
               for n in (1, 129)]
    n2 = 0
    for dtype in (torch.bfloat16, torch.float32):
        for M, K, N in shapes:
            x, w = decode_operands(M, K, N, dtype, gen)
            got = kernel.gated_row_matmul_cuda(x, w)
            plain = ref.gated_row_matmul_ref(x, w)
            torch.cuda.synchronize()
            err2 = max(err2, check_product(got, plain, x, w,
                                           f"K2 {dtype} {M}x{K}x{N}"))
            n2 += 1
    log(f"gated_row_matmul vs plain on the card: {n2} cases, gated rows "
        f"bit-equal, products within tolerance (max |kernel - plain| "
        f"{err2!r})")

    menu = CounterSpec(zvg=True), CounterSpec(
        bic_variants=(bic.MANTISSA_ONLY,))
    full = CounterSpec(bic_variants=tuple(bic.NAMED_SEGMENTS.values()),
                       zvg=True, hist=True)
    seg31 = CounterSpec(bic_variants=tuple((1 << b,) for b in range(15))
                        + tuple(((1 << b) | (1 << ((b + 3) % 16)),)
                                for b in range(16)), zvg=True, hist=True)
    cases = [(4, 1024, 256, torch.bfloat16, torch.float32, *menu, 16, 16),
             (4, 1024, 256, torch.bfloat16, torch.bfloat16, full, full, 16,
              16),
             (1, 1, 1, torch.float32, torch.float32, *menu, 16, 16),
             (3, 63, 129, torch.float32, torch.bfloat16, full, *menu[1:],
              5, 32),
             (7, 100, 7, torch.bfloat16, torch.float32, *menu, 40, 3),
             (5, 257, 300, torch.float32, torch.float32, full, full, 16,
              16),
             # the chunked walk past one chunk a thread, 31 segments
             (9, 4100, 40, torch.bfloat16, torch.float32, seg31, seg31, 16,
              16),
             (1, 1023, 256, torch.bfloat16, torch.float32, menu[0], seg31,
              16, 16)]
    err3 = 0.0
    for B, K, N, adt, wdt, wspec, nspec, lanes_w, cols in cases:
        a, _ = decode_operands(B, K, N, adt, gen)
        _, w = decode_operands(B, K, N, wdt, gen)
        got = kernel.fused_matmul_counters_cuda(a, w, wspec, nspec,
                                                lanes_w, cols)
        want = ref.fused_matmul_counters_ref(a, w, wspec, nspec, lanes_w,
                                             cols)
        torch.cuda.synchronize()
        ctx = f"K3 {adt}x{wdt} {B}x{K}x{N} lanes {lanes_w} cols {cols}"
        for name, g, p in zip(("west_counts", "west_rowzeros",
                               "north_counts", "north_rowzeros"),
                              got[1:], want[1:]):
            if not torch.equal(g, p):
                raise AssertionError(f"{ctx}: {name} differ")
        err3 = max(err3, check_product(got[0], want[0], a, w, ctx))
    log(f"fused_matmul_counters vs plain on the card: {len(cases)} cases, "
        f"the four counter outputs bitwise equal, products within "
        f"tolerance (max |kernel - plain| {err3!r})")
    return err2, err3


# ---------------------------------------------------- serving main path
def serving_requests(vocab: int):
    from repro_torch.serve import SamplingParams

    rng = np.random.default_rng(0)
    lens = rng.integers(16, 129, SERVE_REQUESTS)
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in lens]
    sampling = [SamplingParams(temperature=0.8, top_k=5)
                if i in SERVE_STOCHASTIC else SamplingParams()
                for i in range(SERVE_REQUESTS)]
    return prompts, sampling


def record_gaps(eng) -> dict:
    """Wrap ``eng``'s prefill sampling and decode step so that each
    token's top-two logit gap is kept: ``gaps[(uid, j)]`` is the gap of
    the logits request ``uid``'s token ``j`` was drawn from (the tie rule
    of :func:`compare_runs` reads it)."""
    gaps: dict = {}
    decode, sample_first = eng._decode, eng._sample_first

    def gap(logits):
        v = logits.topk(2, dim=-1).values.float().cpu()
        return list(zip((v[:, 0] - v[:, 1]).tolist(), v[:, 0].tolist()))

    def recording_decode(*args):
        logits = decode(*args)
        g = gap(logits)
        for row in eng.cache.live_slots():
            req = eng._running[row]
            gaps[(req.uid, len(req.generated))] = g[row]
        return logits

    def recording_first(req, logits):
        gaps[(req.uid, len(req.generated))] = gap(logits)[0]
        return sample_first(req, logits)
    eng._decode, eng._sample_first = recording_decode, recording_first
    return gaps


def serve(params, cfg, backend: str, record: bool = False,
          telemetry=None, setup=None):
    """Serve the smoke's requests with ``kernel_backend=backend`` (and
    ``ServeConfig.telemetry``; ``setup(engine)`` before the run).
    Returns ``(engine, {uid: request}, wall seconds, gaps)`` (the gaps of
    :func:`record_gaps` when ``record``)."""
    from repro_torch.serve import ServeConfig, ServeEngine

    eng = ServeEngine(params, cfg, ServeConfig(
        max_slots=SERVE_SLOTS, cache_len=SERVE_CACHE, power_monitor=True,
        kernel_backend=backend, telemetry=telemetry))
    if setup is not None:
        setup(eng)
    gaps = record_gaps(eng) if record else {}
    prompts, sampling = serving_requests(cfg.vocab)
    for p, sp in zip(prompts, sampling):
        eng.submit(p, max_new_tokens=SERVE_MAX_NEW, sampling=sp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {r.uid: r for r in eng.run()}
    torch.cuda.synchronize()
    return eng, done, time.perf_counter() - t0, gaps


def check_served(done: dict, cfg, n: int = SERVE_REQUESTS) -> None:
    """What a serving run must give whatever its kernels: every request
    retired by length with in-vocabulary tokens, finite energies and a
    plausible saving."""
    if len(done) != n:
        raise AssertionError(f"{len(done)} of {n} retired")
    for r in done.values():
        if (r.finish_reason != "length" or len(r.generated) != SERVE_MAX_NEW
                or not all(0 <= t < cfg.vocab for t in r.generated)):
            raise AssertionError(f"request {r.uid}: {r.finish_reason}, "
                                 f"{len(r.generated)} tokens")
        vals = [v for comps in r.power.energy.values()
                for v in comps.values()]
        if not all(np.isfinite(vals)) or not 0 < r.power.saving_total < 1:
            raise AssertionError(f"request {r.uid}: implausible power "
                                 f"report {r.power.summary()}")


def phase_serving():
    """The serving main path with the kernels, then the same requests
    with every plain version; returns what the timings and the kernels
    line need."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.models import lm

    cfg = ARCHS[SERVE_ARCH]
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    counted = (k1.fused_counters_cuda, kz.gated_row_matmul_cuda,
               kz.fused_matmul_counters_cuda)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    eng, done, wall, _ = serve(params, cfg, "auto")
    launches = {fn.__name__: fn.launches for fn in counted}
    check_served(done, cfg)
    steps = eng.stats["decode_steps"]
    per_step = 7 * cfg.n_layers + 1
    want = {"fused_counters_cuda": 4 * SERVE_REQUESTS,
            "gated_row_matmul_cuda": per_step * steps,
            "fused_matmul_counters_cuda": 2 * steps}
    if launches != want:
        raise AssertionError(f"serving launches {launches}, expected {want}")
    log(f"{SERVE_ARCH} serving main path (full width, bf16, {SERVE_SLOTS} "
        f"slots, cache {SERVE_CACHE}, {SERVE_REQUESTS} requests x "
        f"{SERVE_MAX_NEW} tokens): {steps} decode steps, {eng.stats['tokens']}"
        f" tokens in {wall:.3f} s ({eng.stats['tokens'] / wall:.1f} tok/s "
        f"incl. prefill and accounting); launches: gated_row_matmul "
        f"{launches['gated_row_matmul_cuda']} ({per_step} per decode step), "
        f"fused_matmul_counters {launches['fused_matmul_counters_cuda']} "
        f"(2 per sampled step), power_counters "
        f"{launches['fused_counters_cuda']} (prefill accounting)")
    agg = eng.trace_report().summary()
    log(f"serve-wide power: total saving {agg['total_saving']!r}, "
        f"streaming saving {agg['streaming_saving']!r}, mean zero fraction "
        f"{agg['mean_zero_fraction']!r}")

    for fn in counted:
        fn.launches = 0
    ref_eng, ref_done, ref_wall, gaps = serve(params, cfg, "ref",
                                              record=True)
    if any(fn.launches for fn in counted):
        raise AssertionError("the plain run launched a kernel")
    check_served(ref_done, cfg)
    log(f"the same requests with kernel_backend='ref' (every plain "
        f"version): {ref_wall:.3f} s")
    equal = compare_runs(done, ref_done, gaps, SERVE_STOCHASTIC,
                         "the plain run")
    if equal == len(done):
        assert_reports_close(eng, ref_eng, "the plain run's")
    return cfg, params, eng, done, launches


def assert_close(got: float, want: float, ctx: str) -> None:
    if not abs(got - want) <= 1e-6 * abs(want):
        raise AssertionError(f"{ctx}: {got!r} vs {want!r} beyond rtol 1e-6")


def assert_reports_close(eng, ref_eng, what: str) -> None:
    rep, ref_rep = eng.trace_report(), ref_eng.trace_report()
    if [s.name for s in rep.sites] != [s.name for s in ref_rep.sites]:
        raise AssertionError(f"trace_report() sites differ from {what}")
    for site, ref_site in zip(rep.sites, ref_rep.sites):
        for d, comps in ref_site.designs.items():
            for c, v in comps.items():
                assert_close(site.designs[d][c], v,
                             f"trace_report {site.name} {d}/{c}")
    log(f"trace_report() aggregates equal {what} (rtol 1e-6)")


def compare_runs(done: dict, ref_done: dict, gaps: dict, stochastic,
                 what: str, same_prefill: bool = True) -> int:
    """Greedy tokens equal across the two runs, or a tie in the reference
    run's logits where they part (``gaps`` from :func:`record_gaps` on
    the reference run). With ``same_prefill`` both runs prefill every
    request alike (the same plain prefill, no shared prefixes, no
    preemption): a first-token difference fails outright, and the
    energies of every request with equal tokens agree within rtol 1e-6.
    Without it (a run with chunked prefill, shared prefixes or preemption
    against the uncontended run) a first token too may part at a tie,
    and energies are not compared: those features change what a request
    pays. Requests in ``stochastic`` that part are logged, not compared.
    Returns how many requests had equal tokens."""
    equal = 0
    for uid, r in done.items():
        p = ref_done[uid]
        if r.generated == p.generated:
            equal += 1
            if not same_prefill:
                continue
            for d, comps in p.power.energy.items():
                for c, v in comps.items():
                    assert_close(r.power.energy[d][c], v,
                                 f"request {uid} energy {d}/{c}")
            continue
        if uid in stochastic:
            log(f"request {uid} (sampled): tokens part from {what}'s; not "
                f"compared")
            continue
        j = next(i for i, (a, b) in enumerate(zip(r.generated, p.generated))
                 if a != b)
        if j == 0 and same_prefill:
            raise AssertionError(
                f"greedy request {uid} parts from {what} at its first token,"
                f" which both runs draw from the same prefill")
        margin, top = gaps[(uid, j)]
        if not margin < tie_limit(top):
            raise AssertionError(
                f"greedy request {uid} parts from {what} at token {j}, "
                f"top-2 logit margin {margin!r}")
        log(f"greedy request {uid}: a tie -- the tokens part at token {j} "
            f"where {what}'s top two logits are {margin!r} apart "
            f"(< {tie_limit(top)})")
    log(f"{equal} of {len(done)} requests' tokens equal {what}'s"
        + ("; their per-request energies agree within rtol 1e-6"
           if same_prefill else ""))
    return equal


# ------------------------------------------------- paged attention (K4)
def paged_attention_bytes(k_pool, q, pages, lengths) -> int:
    """Bytes the paged decode attention must move: each K and V position
    below some row's length once (rows that share a prefix page need it
    once), q and the output, the tables and lengths."""
    _, ps, kv, hd = k_pool.shape
    pos = torch.arange(pages.shape[1] * ps, device=pages.device)
    slots = pages.long().repeat_interleave(ps, dim=1) * ps + pos % ps
    used = slots[pos[None, :] < lengths.long()[:, None]].unique().numel()
    return (used * kv * hd * 2 * k_pool.element_size()
            + 2 * q.numel() * q.element_size()
            + 4 * (pages.numel() + lengths.numel()))


def phase_paged_kernel_cases() -> tuple[dict, float, dict]:
    """K4 against its plain version on the card over the case list, once
    for each of ``PAGED_SEEDS``: ``rep`` 1 to 8, hd 16 to 128, ps 8, 16,
    32, B 1 to 8, softcap 0 and 5, bfloat16 and float32, and the serving
    shape. bfloat16 outputs are also held per element against the float32
    plain version of the same inputs (``cases.bf16_ulp_error``). Beside
    each case, a planted fault: the kernel with each row's last position
    cut off (``lengths - 1`` where above 1), which the checks must catch
    in every case. Returns the largest relative error per dtype, the
    largest absolute one, and the planted fault's readings per dtype (its
    smallest and largest relative error, in how many cases the checks
    catch it, and of how many)."""
    from repro_torch.kernels.zvg_matmul import kernel, ref
    from repro_torch.kernels.zvg_matmul.cases import (ATTN_BF16_ABS,
                                                      ATTN_TOL, PAGED_CASES,
                                                      bf16_ulp_error,
                                                      paged_case,
                                                      relative_error)
    from repro_torch.models.attention import decode_attention

    names = {d: str(d).split(".")[-1] for d in ATTN_TOL}
    err = dict.fromkeys(names.values(), 0.0)
    fault = {n: [] for n in names.values()}
    caught = dict.fromkeys(names.values(), 0)
    ulp_err, fault_ulp = 0.0, []
    abs_err = 0.0
    for seed in PAGED_SEEDS:
        for i, (*shape, cap) in enumerate(PAGED_CASES):
            for dtype, name in names.items():
                q, kp, vp, pages, lengths = paged_case(
                    *shape, dtype, seed=1000 * seed + i)
                got = kernel.fused_paged_attention_cuda(
                    q, kp, vp, pages, lengths, softcap=cap)
                want = ref.fused_paged_attention_ref(
                    q, kp, vp, pages, lengths, decode_attention, softcap=cap)
                rel = relative_error(got, want)
                abs_err = max(abs_err, float((got.float() - want.float())
                                             .abs().max()))
                ctx = (f"K4 {name} seed {seed} (B, kv, rep, hd, ps, mp) "
                       f"{tuple(shape)} softcap {cap} lengths "
                       f"{lengths.tolist()}")
                if not rel <= ATTN_TOL[dtype]:
                    raise AssertionError(f"{ctx}: relative error {rel!r} "
                                         f"over {ATTN_TOL[dtype]}")
                err[name] = max(err[name], rel)
                want32 = None
                if dtype == torch.bfloat16:
                    # per element, against the float32 plain version of
                    # the same bfloat16 inputs
                    want32 = ref.fused_paged_attention_ref(
                        *[t.float() for t in (q, kp, vp)], pages, lengths,
                        decode_attention, softcap=cap)
                    u = bf16_ulp_error(got, want32)
                    if not u <= 1:
                        raise AssertionError(f"{ctx}: {u!r} bf16 units "
                                             f"from the float32 plain "
                                             f"version")
                    ulp_err = max(ulp_err, u)
                if (lengths > 1).any():
                    cut = kernel.fused_paged_attention_cuda(
                        q, kp, vp, pages, lengths - (lengths > 1).int(),
                        softcap=cap)
                    fault[name].append(relative_error(cut, want))
                    hit = fault[name][-1] > ATTN_TOL[dtype]
                    if want32 is not None:
                        fault_ulp.append(bf16_ulp_error(cut, want32))
                        hit = hit or fault_ulp[-1] > 1
                    caught[name] += hit
    fault = {name: {"min": min(fault[name]), "max": max(fault[name]),
                    "caught_by_rel_tol": sum(f > ATTN_TOL[d]
                                             for f in fault[name]),
                    "caught": caught[name], "of": len(fault[name])}
             for d, name in names.items()}
    fault["bfloat16"]["ulp_min"] = min(fault_ulp)
    for dtype, name in names.items():
        if fault[name]["caught"] != fault[name]["of"]:
            raise AssertionError(f"the checks miss a planted fault in "
                                 f"{name}: {fault[name]}")
        log(f"fused_paged_attention planted fault ({name}): caught "
            f"{fault[name]['caught']} of {fault[name]['of']}")
    log(f"fused_paged_attention vs plain on the card: {len(PAGED_CASES)} "
        f"cases x 2 dtypes x {len(PAGED_SEEDS)} seeds (trash-page and "
        f"shared-page rows, lengths 1, ragged and full), max relative error "
        f"{json.dumps(err)} within "
        f"{json.dumps({names[d]: t for d, t in ATTN_TOL.items()})}; max "
        f"|kernel - plain| {abs_err!r}; bf16 per element within "
        f"{ulp_err!r} of one bf16 unit (+ {ATTN_BF16_ABS} of the largest) "
        f"of the float32 plain version; planted fault (last position cut "
        f"off) {json.dumps(fault)}")
    fault["bf16_ulp_err"] = ulp_err
    return err, abs_err, fault


# ----------------------------------------------------- paged serving runs
def paged_requests(vocab: int) -> list[dict]:
    """Run (b)'s requests as ``submit`` arguments: a shared system prompt
    and a suffix each, from ``default_rng(1)``; the "hi" class and the
    sampled requests by index."""
    from repro_torch.serve import SamplingParams

    rng = np.random.default_rng(1)
    system = rng.integers(0, vocab, PAGED_SYSTEM).tolist()
    reqs = []
    for i in range(PAGED_REQUESTS):
        suffix = rng.integers(0, vocab, int(rng.integers(8, 97))).tolist()
        reqs.append({
            "prompt": system + suffix, "max_new_tokens": SERVE_MAX_NEW,
            "sampling": (SamplingParams(temperature=0.8, top_k=5)
                         if i in PAGED_STOCHASTIC else SamplingParams()),
            "klass": "hi" if i in PAGED_HI else "default"})
    return reqs


def serve_paged(params, cfg, requests, backend: str, record: bool = False,
                telemetry=None, setup=None, **paging):
    """Serve ``requests`` (``submit`` arguments) on a paged engine (with
    ``ServeConfig.telemetry``; ``setup(engine)`` before the run).
    Returns ``(engine, {uid: request}, wall seconds, gaps, launches)``,
    the launches of K1-K4 in the run by wrapper name."""
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.serve import (PagingConfig, Request, SchedClass,
                                   ServeConfig, ServeEngine)

    classes = (SchedClass("default"), SchedClass("hi", priority=1))
    eng = ServeEngine(params, cfg, ServeConfig(
        cache_len=SERVE_CACHE, power_monitor=True, kernel_backend=backend,
        telemetry=telemetry,
        paging=PagingConfig(page_size=PAGE, classes=classes, **paging)))
    if setup is not None:
        setup(eng)
    gaps = record_gaps(eng) if record else {}
    for r in requests:
        eng.submit(Request(**r))
    counted = (k1.fused_counters_cuda, kz.gated_row_matmul_cuda,
               kz.fused_matmul_counters_cuda, kz.fused_paged_attention_cuda)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    done = {r.uid: r for r in eng.run()}
    torch.cuda.synchronize()
    return (eng, done, time.perf_counter() - t0, gaps,
            {fn.__name__: fn.launches for fn in counted})


def check_paged(eng, done: dict, n: int, cfg, launches: int, kernels: bool,
                what: str) -> None:
    """What every paged run must give: all requests retired by length,
    every page back in the free list or the prefix cache, retired
    energies summing to the trace, and with the kernels K4 launched once
    a layer a decode step, K2 at every decode matmul, K3 twice a sampled
    step and K1 four times an admission (two sites, two edges); without
    them, no kernel at all."""
    check_served(done, cfg, n)
    c = eng.cache
    cached = len(eng.prefix) if eng.prefix is not None else 0
    if c.n_live or c.n_free_pages + cached != c.num_pages - 1:
        raise AssertionError(f"{what}: pages not conserved ({c.n_live} rows "
                             f"in use, {c.n_free_pages} free, {cached} "
                             f"cached of {c.num_pages - 1})")
    rep = eng.trace_report()
    for design in eng.accountant.mcfg.design_names:
        assert_close(sum(s.energy(design) for s in rep.sites),
                     sum(r.power.energy[design]["total"]
                         for r in done.values()),
                     f"{what}: retired {design} energies vs the trace")
    steps = eng.stats["decode_steps"]
    want = {"fused_counters_cuda": 4 * c.allocations,
            "gated_row_matmul_cuda": (7 * cfg.n_layers + 1) * steps,
            "fused_matmul_counters_cuda": 2 * steps,
            "fused_paged_attention_cuda": cfg.n_layers * steps}
    if not kernels:
        want = dict.fromkeys(want, 0)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    st = eng.stats
    log(f"{what}: {st['decode_steps']} decode steps, {st['tokens']} tokens; "
        f"launches {json.dumps(launches)}; chunk_calls {st['chunk_calls']}, "
        f"prefix_hit_requests {st['prefix_hit_requests']}, peak_admitted "
        f"{st['peak_admitted']}, preemptions {st['preemptions']}; pages "
        f"conserved ({c.n_free_pages} free + {cached} cached); retired "
        f"energies sum to the trace (rtol 1e-6)")


def phase_paged_serving(cfg, params, slot_eng, slot_done: dict) -> dict:
    """The paged engine at the full width of Qwen1.5-0.5B: (a) with ample
    pages it serves the slot run's requests with the slot engine's tokens
    and energies; (b) at the slot run's memory (64 usable pages of 16) it
    serves 16 requests with a shared system prompt through 8 rows with
    chunked prefill, prefix sharing and two classes; (c) with 32 usable
    pages it must preempt. Greedy tokens of (b) and (c) are held against
    an uncontended run, and (b) against the same run with every plain
    version."""
    prompts, sampling = serving_requests(cfg.vocab)
    slot_reqs = [{"prompt": p, "max_new_tokens": SERVE_MAX_NEW,
                  "sampling": sp} for p, sp in zip(prompts, sampling)]
    eng, done, wall, gaps, launched = serve_paged(
        params, cfg, slot_reqs, "auto", record=True, num_pages=65,
        max_rows=SERVE_SLOTS)
    check_paged(eng, done, SERVE_REQUESTS, cfg, launched, True,
                "paged run (a), ample pages")
    equal = compare_runs(slot_done, done, gaps, SERVE_STOCHASTIC,
                         "the paged run (a)")
    if equal == SERVE_REQUESTS:
        assert_reports_close(slot_eng, eng, "the paged run (a)'s")
    log(f"paged run (a) against the slot engine: {equal} of "
        f"{SERVE_REQUESTS} requests' tokens equal, {wall:.3f} s")
    out = {"a": {"decode_steps": eng.stats["decode_steps"],
                 "launches": launched["fused_paged_attention_cuda"],
                 "equal": equal, "wall_s": wall}}

    reqs = paged_requests(cfg.vocab)
    base, base_done, _, base_gaps, launched = serve_paged(
        params, cfg, reqs, "auto", record=True, num_pages=129,
        max_rows=PAGED_ROWS)
    check_paged(base, base_done, PAGED_REQUESTS, cfg, launched, True,
                "uncontended paged run (128 usable pages)")
    if base.stats["preemptions"]:
        raise AssertionError("the uncontended run preempted")
    runs = {}
    for name, pages in (("b", 65), ("c", 33)):
        eng, done, wall, _, launched = serve_paged(
            params, cfg, reqs, "auto", num_pages=pages, max_rows=PAGED_ROWS,
            prefill_chunk=64, prefix_cache=True)
        what = f"paged run ({name}), {pages - 1} usable pages"
        check_paged(eng, done, PAGED_REQUESTS, cfg, launched, True, what)
        st = eng.stats
        if not (st["chunk_calls"] > 0 and st["prefix_hit_requests"] > 0
                and st["peak_admitted"] > SERVE_SLOTS):
            raise AssertionError(f"{what}: no chunks, prefix hits or "
                                 f"admitted concurrency over the slot "
                                 f"engine's {SERVE_SLOTS}: {st}")
        if name == "c" and not st["preemptions"] > 0:
            raise AssertionError(f"{what}: nothing was preempted")
        tokens = eng.stats["tokens"]
        log(f"{what}: {wall:.3f} s, {tokens / wall:.1f} tok/s incl. prefill "
            f"and accounting")
        compare_runs(done, base_done, base_gaps, PAGED_STOCHASTIC,
                     "the uncontended run", same_prefill=False)
        runs[name] = (eng, done)
        out[name] = {"wall_s": wall, "tokens": tokens,
                     "launches": launched["fused_paged_attention_cuda"],
                     "launches_all": launched,
                     **{k: st[k] for k in ("decode_steps", "chunk_calls",
                                           "prefix_hit_requests",
                                           "peak_admitted", "preemptions")}}
    eng, done = runs["b"]
    ref_eng, ref_done, ref_wall, ref_gaps, launched = serve_paged(
        params, cfg, reqs, "ref", record=True, num_pages=65,
        max_rows=PAGED_ROWS, prefill_chunk=64, prefix_cache=True)
    check_paged(ref_eng, ref_done, PAGED_REQUESTS, cfg, launched, False,
                "paged run (b) with kernel_backend='ref'")
    equal = compare_runs(done, ref_done, ref_gaps, PAGED_STOCHASTIC,
                         "the plain paged run")
    if equal == PAGED_REQUESTS:
        assert_reports_close(eng, ref_eng, "the plain paged run's")
    out["b_ref_wall_s"] = ref_wall
    out["engine"] = eng
    return out


# ------------------------------------ telemetry and actuation (K1-K4)
#: the telemetry window (retirements) of the Qwen1.5-0.5B runs, the loop
#: closed: flips found on a window are committed at the next step
TELEMETRY_WINDOW = 2


def timed_telemetry(eng, timer: dict) -> None:
    """Time ``eng``'s telemetry on the host: the retirement hook (the
    registry and, as windows close, the selector) and the step
    boundary's swap commit, summed into ``timer``."""
    hooks = eng.accountant.retire_hooks
    on_retire = hooks[-1]

    def timed_retire(rec):
        t0 = time.perf_counter()
        on_retire(rec)
        timer["retire_s"] += time.perf_counter() - t0
        timer["retirements"] += 1
    hooks[-1] = timed_retire
    swaps = eng._apply_design_swaps

    def timed_swaps():
        t0 = time.perf_counter()
        swaps()
        timer["swap_s"] += time.perf_counter() - t0
    eng._apply_design_swaps = timed_swaps


def telemetry_counters_equal(reg, ref_reg, tokens_equal: set,
                             what: str) -> dict:
    """Window by window, the site counters of two runs' registries: the
    windows hold the same retirements, every counted key (toggles, zero
    counts) is bitwise equal and every priced energy key within rtol
    1e-6 (how many are bitwise is returned). Windows holding a request
    whose tokens parted (at a tie, :func:`compare_runs`) are skipped and
    counted."""
    win, ref_win = reg.closed_windows(), ref_reg.closed_windows()
    if [(w.index, w.seqs, w.uids) for w in win] != \
            [(w.index, w.seqs, w.uids) for w in ref_win]:
        raise AssertionError(f"{what}: the windows hold other requests")
    stats = {"windows": len(win), "skipped": 0, "counted_keys": 0,
             "energy_keys": 0, "energy_bitwise": 0}
    for w, v in zip(win, ref_win):
        if not set(w.uids) <= tokens_equal:
            stats["skipped"] += 1
            continue
        got, want = w.site_counters(), v.site_counters()
        if got.keys() != want.keys():
            raise AssertionError(f"{what} window {w.index}: sites differ")
        for site, c in want.items():
            if got[site].keys() != c.keys():
                raise AssertionError(f"{what} window {w.index} {site}: "
                                     f"keys differ")
            for k, x in c.items():
                if k.startswith("e/"):
                    assert_close(got[site][k], x,
                                 f"{what} window {w.index} {site} {k}")
                    stats["energy_keys"] += 1
                    stats["energy_bitwise"] += got[site][k] == x
                elif got[site][k] != x:
                    raise AssertionError(
                        f"{what} window {w.index} {site} {k}: "
                        f"{got[site][k]!r} vs {x!r}")
                else:
                    stats["counted_keys"] += 1
    return stats


def timeline_key(tl) -> tuple:
    """The decisions of a timeline: choices, flips and swaps."""
    return ([(w.window, w.choices, w.raw_choices) for w in tl.windows],
            [(f.window, f.site, f.old, f.new) for f in tl.flip_events],
            [(e.epoch, e.window, e.sites) for e in tl.swaps])


def windows_sum_to_trace(eng, what: str) -> None:
    """The registry's windows replayed in retirement order give the
    serve-wide report bit for bit (without the actuated pseudo-design,
    which ``trace_report()`` adds from the accountant)."""
    from repro_torch.trace.report import build_report

    model = f"serve/{eng.cfg.name}"
    merged = eng.telemetry.registry.merged_report(model=model)
    want = build_report(eng.accountant.capture, model=model)
    if json.dumps(merged.to_json_dict(), sort_keys=True) != \
            json.dumps(want.to_json_dict(), sort_keys=True):
        raise AssertionError(f"{what}: windows do not sum to the trace")


def compare_telemetry(eng, done: dict, ref_eng, ref_done: dict,
                      equal_uids: set, what: str) -> dict:
    """Telemetry of a run with the kernels against its plain run: the
    windows' counters (:func:`telemetry_counters_equal`), the same flip
    and swap timeline, actuated totals and savings tracks within rtol
    1e-6 -- where every request's tokens are equal -- and in each run
    the windows summing to the trace bit for bit."""
    for e, w in ((eng, what), (ref_eng, f"{what}'s plain run")):
        e.telemetry.finalize()
        windows_sum_to_trace(e, w)
        retired = {r.uid for r in e.telemetry.registry.records}
        if retired != set(done):
            raise AssertionError(f"{w}: the registry saw {len(retired)} "
                                 f"retirements")
    stats = telemetry_counters_equal(
        eng.telemetry.registry, ref_eng.telemetry.registry, equal_uids, what)
    tl, ref_tl = eng.telemetry.timeline, ref_eng.telemetry.timeline
    all_equal = equal_uids >= set(done)
    if all_equal:
        if timeline_key(tl) != timeline_key(ref_tl):
            raise AssertionError(f"{what}: the timeline differs from the "
                                 f"plain run's")
        tot, ref_tot = (eng.accountant.actuated_totals(),
                        ref_eng.accountant.actuated_totals())
        for c, v in ref_tot.items():
            assert_close(tot[c], v, f"{what} actuated {c}")
        sm, ref_sm = tl.summary(), ref_tl.summary()
        for k, v in ref_sm.items():
            if k.startswith("saving_") and not abs(sm[k] - v) <= 1e-6:
                raise AssertionError(f"{what} {k}: {sm[k]!r} vs {v!r}")
        for r in done.values():
            p = ref_done[r.uid].power.energy["actuated"]
            for c, v in p.items():
                assert_close(r.power.energy["actuated"][c], v,
                             f"{what} request {r.uid} actuated {c}")
    sm = tl.summary()
    log(f"{what} telemetry (window {eng.telemetry.tcfg.window}, actuate "
        f"{eng.telemetry.tcfg.actuate}): {sm['n_windows']} windows, "
        f"{sm['n_flips']} flips, {sm['n_swaps']} swaps; savings fixed "
        f"{sm.get('saving_fixed')!r}, online {sm.get('saving_online')!r}, "
        f"oracle {sm.get('saving_oracle')!r}, actuated "
        f"{sm.get('saving_actuated')!r}; against the plain run: "
        f"{stats['windows'] - stats['skipped']} of {stats['windows']} "
        f"windows compared, {stats['counted_keys']} counted keys bitwise, "
        f"{stats['energy_bitwise']} of {stats['energy_keys']} energy keys "
        f"bitwise (all within rtol 1e-6)"
        + ("; timeline, actuated totals and savings tracks equal"
           if all_equal else "; timeline not compared: tokens parted")
        + "; windows sum to the trace bit for bit")
    return {"summary": sm, "compared": stats, "timeline_compared": all_equal,
            "flips": [f.to_json_dict() for f in tl.flip_events],
            "swaps": [e.to_json_dict() for e in tl.swaps]}


def phase_telemetry(cfg, params) -> dict:
    """Windowed telemetry with the loop closed on the serving main path
    (Qwen1.5-0.5B at full width, ``phase_serving``'s model): the slot
    engine on its 8 requests, then paged run (b) (16 requests, chunks,
    prefix sharing, two classes), each with ``TelemetryConfig(window=2,
    actuate=True)``, with the kernels (K1-K3, and K4 in the paged run)
    and with every plain version (:func:`compare_telemetry`); then the
    JAX package's three scenarios at their smoke configs through
    ``run_scenario(device="cuda")``, with the kernels and with
    ``kernel_backend="ref"``, where ``shift`` must flip its prefill sites
    from mant-exp to bic-west as the JAX tests assert."""
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.serve.telemetry import TelemetryConfig
    from repro_torch.serve.telemetry.scenarios import SCENARIOS, run_scenario

    counted = (k1.fused_counters_cuda, kz.gated_row_matmul_cuda,
               kz.fused_matmul_counters_cuda, kz.fused_paged_attention_cuda)
    tcfg = TelemetryConfig(window=TELEMETRY_WINDOW, actuate=True)
    out = {}

    def run(label, backend, fn):
        timer = {"retire_s": 0.0, "swap_s": 0.0, "retirements": 0}
        torch.cuda.synchronize()
        for f in counted:
            f.launches = 0
        eng, done, wall, gaps = fn(lambda e: timed_telemetry(e, timer))
        t0 = time.perf_counter()
        eng.telemetry.finalize()
        finalize_s = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in counted}
        kernels = backend == "auto"
        if any(v > 0 for k, v in launches.items()
               if k != "fused_paged_attention_cuda") != kernels:
            raise AssertionError(f"{label}: launches {launches}")
        ms = 1e3 * timer["retire_s"] / max(timer["retirements"], 1)
        log(f"{label} with telemetry, kernel_backend={backend!r}: "
            f"{eng.stats['decode_steps']} decode steps, "
            f"{eng.stats['tokens']} tokens in {wall:.3f} s; launches "
            f"{json.dumps(launches)}; telemetry host time "
            f"{ms:.4f} ms a retirement ({timer['retirements']} "
            f"retirements), swap commits {1e3 * timer['swap_s']:.3f} ms "
            f"over {eng.stats['steps']} steps, finalize "
            f"{1e3 * finalize_s:.3f} ms")
        out[f"{label} {backend}"] = {
            "wall_s": wall, "tokens": eng.stats["tokens"],
            "decode_steps": eng.stats["decode_steps"],
            "launches": launches, "retirements": timer["retirements"],
            "retire_ms": ms, "swap_ms": 1e3 * timer["swap_s"],
            "finalize_ms": 1e3 * finalize_s}
        return eng, done, gaps, launches

    def slot(setup, backend):
        eng, done, wall, gaps = serve(params, cfg, backend,
                                      record=backend == "ref",
                                      telemetry=tcfg, setup=setup)
        return eng, done, wall, gaps

    def paged(setup, backend):
        eng, done, wall, gaps, _ = serve_paged(
            params, cfg, paged_requests(cfg.vocab), backend,
            record=backend == "ref", telemetry=tcfg, setup=setup,
            num_pages=65, max_rows=PAGED_ROWS, prefill_chunk=64,
            prefix_cache=True)
        return eng, done, wall, gaps

    for label, fn, n, stochastic in (
            ("slot run", slot, SERVE_REQUESTS, SERVE_STOCHASTIC),
            ("paged run (b)", paged, PAGED_REQUESTS, PAGED_STOCHASTIC)):
        eng, done, _, launches = run(label, "auto",
                                     lambda st, fn=fn: fn(st, "auto"))
        ref_eng, ref_done, gaps, _ = run(label, "ref",
                                         lambda st, fn=fn: fn(st, "ref"))
        check_served(done, cfg, n)
        check_served(ref_done, cfg, n)
        steps = eng.stats["decode_steps"]
        want = {"gated_row_matmul_cuda": (7 * cfg.n_layers + 1) * steps,
                "fused_matmul_counters_cuda": 2 * steps,
                "fused_paged_attention_cuda": (cfg.n_layers * steps
                                               if label.startswith("paged")
                                               else 0)}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"{label} with telemetry: launches "
                                 f"{launches}, expected {want}")
        compare_runs(done, ref_done, gaps, stochastic,
                     f"{label}'s plain run with telemetry")
        equal = {u for u, r in done.items()
                 if r.generated == ref_done[u].generated}
        out[label] = compare_telemetry(eng, done, ref_eng, ref_done, equal,
                                       f"{label} with telemetry")
        del eng, ref_eng
        gc.collect()

    for name, sc in sorted(SCENARIOS.items()):
        runs = {}
        for backend in ("auto", "ref"):
            torch.cuda.synchronize()
            for f in counted:
                f.launches = 0
            t0 = time.perf_counter()
            res = run_scenario(name, tcfg=TelemetryConfig(
                window=sc.window, actuate=True), device="cuda",
                kernel_backend=backend)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {f.__name__: f.launches for f in counted}
            if (launches["gated_row_matmul_cuda"] > 0) != \
                    (backend == "auto"):
                raise AssertionError(f"scenario {name} {backend}: "
                                     f"launches {launches}")
            runs[backend] = res
            eng = res["engine"]
            out[f"scenario {name} {backend}"] = {
                "wall_s": wall, "tokens": eng.stats["tokens"],
                "decode_steps": eng.stats["decode_steps"],
                "launches": launches}
            log(f"scenario {name!r} ({sc.arch} smoke, float32, window "
                f"{sc.window}, actuated, kernel_backend={backend!r}): "
                f"{len(res['finished'])} requests, {eng.stats['tokens']} "
                f"tokens in {wall:.3f} s; launches {json.dumps(launches)}")
        res, ref = runs["auto"], runs["ref"]
        done = {r.uid: r for r in res["finished"]}
        ref_done = {r.uid: r for r in ref["finished"]}
        equal = {u for u, r in done.items()
                 if r.generated == ref_done[u].generated}
        if len(equal) < len(done):
            log(f"scenario {name!r}: {len(done) - len(equal)} requests' "
                f"tokens part from the plain run's")
        out[f"scenario {name}"] = compare_telemetry(
            res["engine"], done, ref["engine"], ref_done, equal,
            f"scenario {name!r}")
        if name == "shift":
            tl = res["timeline"]
            prefill = [f for f in tl.flip_events
                       if f.site.startswith("prefill/")]
            if not prefill or any(
                    (f.old, f.new) != ("mant-exp", "bic-west")
                    or not f.margin > 0 or f.window < 1 for f in prefill):
                raise AssertionError(f"scenario 'shift' did not flip its "
                                     f"prefill sites mant-exp -> bic-west: "
                                     f"{tl.flip_events}")
            log(f"scenario 'shift' flips its prefill sites mant-exp -> "
                f"bic-west at windows "
                f"{sorted({f.window for f in prefill})}")
    return out


# --------------------------------------- quickstart path: K5, K6, K7
def word_err(*pairs) -> int:
    """The largest |got - want| over ``(got, want)`` pairs of integer or
    bool tensors: 0 when each pair is bitwise equal."""
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in pairs)


def phase_stream_kernel_cases() -> tuple[int, int]:
    """K5 and K6 against their plain versions on the card, bitwise, over
    the case list of ``repro_torch.kernels.transitions.cases`` (every
    mask, with and without ``init``, uint16 and int32 words; K5 also at
    every edge of its plan); K6's output must decode back to its input.
    Returns K5's and K6's largest |kernel - plain| (0: bitwise equal)."""
    from repro_torch.core import bic
    from repro_torch.kernels.bic_encode import kernel as k6
    from repro_torch.kernels.bic_encode.ref import bic_encode_ref
    from repro_torch.kernels.power_counters.cases import PLAN_EDGES
    from repro_torch.kernels.transitions import kernel as k5
    from repro_torch.kernels.transitions.cases import (
        BIC_MASKS, BIC_SHAPES, TRANSITION_MASKS, TRANSITION_PLAN_EDGES,
        TRANSITION_SHAPES, stream_words)
    from repro_torch.kernels.transitions.ref import transitions_ref

    n5 = n6 = err5 = err6 = 0
    for T, L in TRANSITION_SHAPES + TRANSITION_PLAN_EDGES:
        x = stream_words(T, L, seed=T + L)
        init = stream_words(1, L, seed=L)[0]
        for mask in TRANSITION_MASKS:
            for i in (None, init):
                want = transitions_ref(x, mask, i)
                for words in (x, x.to(torch.uint16)):
                    got = k5.transitions_cuda(words, mask, i)
                    err5 = max(err5, word_err((got, want)))
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K5 {T}x{L} mask {mask:#x} init "
                            f"{i is not None} {words.dtype}: kernel != "
                            f"plain version")
                    n5 += 1
    for T, L in BIC_SHAPES:
        x = stream_words(T, L, seed=T * L)
        for mask in BIC_MASKS:
            for words in (x, x.to(torch.uint16)):
                tx, inv = k6.bic_encode_cuda(words, mask)
                want_tx, want_inv = bic_encode_ref(words, mask)
                ctx = f"K6 {T}x{L} mask {mask:#x} {words.dtype}"
                err6 = max(err6, word_err((tx, want_tx), (inv, want_inv)))
                if not (torch.equal(tx, want_tx)
                        and torch.equal(inv, want_inv)):
                    raise AssertionError(f"{ctx}: kernel != plain version")
                if not torch.equal(bic.bic_decode(tx, inv[:, None, :],
                                                  (mask,)), x):
                    raise AssertionError(f"{ctx}: does not decode back")
                n6 += 1
    for T in PLAN_EDGES:   # the plan's edges, as K1's
        for L in (1, 33):
            x = stream_words(T, L, seed=T * 5 + L)
            for mask in BIC_MASKS:
                for words in (x, x.to(torch.uint16)):
                    tx, inv = k6.bic_encode_cuda(words, mask)
                    want_tx, want_inv = bic_encode_ref(words, mask)
                    err6 = max(err6, word_err((tx, want_tx),
                                              (inv, want_inv)))
                    if not (torch.equal(tx, want_tx)
                            and torch.equal(inv, want_inv)
                            and torch.equal(bic.bic_decode(
                                tx, inv[:, None, :], (mask,)), x)):
                        raise AssertionError(
                            f"K6 edge {T}x{L} mask {mask:#x} "
                            f"{words.dtype}: kernel != plain version")
                    n6 += 1
    torch.cuda.synchronize()
    log(f"transitions vs plain on the card: {n5} cases bitwise equal; "
        f"bic_encode vs plain: {n6} cases bitwise equal, each decoding "
        f"back to its input")
    return err5, err6


def phase_tiled_kernel_cases() -> tuple[dict, float]:
    """K7 against its plain version on the card over ``TILED_CASES`` (the
    JAX package's shapes and block sweep, planted zero blocks, all-zero
    ``a``, a -0.0 tile, a NaN tile), float32 and bfloat16, once for each
    of ``PAGED_SEEDS``: gated maps equal, products within ``TILED_TOL``.
    The plain version's product is full float32 only with TF32 off, so
    that is checked first. Returns the largest relative error per dtype
    and the largest absolute one."""
    from repro_torch.kernels.zvg_matmul import kernel, ref
    from repro_torch.kernels.zvg_matmul.cases import (TILED_CASES, TILED_TOL,
                                                      tiled_case,
                                                      tiled_error)

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is let into float32 matmuls: the plain "
                             "tile-gated product would be off by ~1e-3")
    names = {d: str(d).split(".")[-1] for d in TILED_TOL}
    err = dict.fromkeys(names.values(), 0.0)
    abs_err = 0.0
    for seed in PAGED_SEEDS:
        for M, K, N, bm, bn, bk, zf, plant in TILED_CASES:
            for dtype, name in names.items():
                a, b = tiled_case(M, K, N, zf, plant, dtype,
                                  seed=1000 * seed + M + K)
                out, gated = kernel.zvg_matmul_cuda(a, b, bm, bn, bk)
                want, want_gated = ref.zvg_matmul_ref(a, b, bm, bk)
                ctx = (f"K7 {name} seed {seed} {M}x{K}x{N} blocks "
                       f"({bm}, {bn}, {bk}) {plant or zf}")
                if not torch.equal(gated, want_gated):
                    raise AssertionError(f"{ctx}: gated maps differ")
                if plant == "zero_blocks" and int(gated.sum()) != 2:
                    raise AssertionError(f"{ctx}: {int(gated.sum())} tiles "
                                         f"gated, planted 2")
                rel = tiled_error(out, want)
                if not rel <= TILED_TOL[dtype]:
                    raise AssertionError(f"{ctx}: relative error {rel!r} "
                                         f"over {TILED_TOL[dtype]}")
                err[name] = max(err[name], rel)
                fin = ~torch.isnan(want)
                if fin.any():
                    abs_err = max(abs_err, float((out - want)[fin].abs()
                                                 .max()))
    log(f"zvg_matmul vs plain on the card: {len(TILED_CASES)} cases x 2 "
        f"dtypes x {len(PAGED_SEEDS)} seeds, gated maps equal, max "
        f"relative error {json.dumps(err)} within "
        f"{json.dumps({names[d]: t for d, t in TILED_TOL.items()})}; max "
        f"|kernel - plain| {abs_err!r}")
    return err, abs_err


def phase_fault6() -> dict:
    """The operands the card kernels refused before (ROADMAP fault 6),
    each held against its plain version on the card: K7 at blocks that
    are not multiples of its row tile or k stage, in both dtypes (the
    gated map equal, the product within ``TILED_TOL``); K2 on int8 with
    each partner at 4, 8 and 9 rows (int8 x int8 equal, x @ w mod 256;
    the float pairs within ``PRODUCT_TOL``; gated rows zero); K2 at K =
    40000 and 65536, past what 16 splits stage at once."""
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.kernels.zvg_matmul import ref
    from repro_torch.kernels.zvg_matmul.cases import (TILED_TOL, tiled_case,
                                                      tiled_error)

    out = {"k7_blocks": [], "k2_int8": [], "k2_long_k": []}
    for M, K, N, bm, bk in ((70, 90, 40, 32, 8), (200, 130, 24, 96, 24),
                            (230, 150, 33, 200, 40), (49, 1152, 256, 32, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            a, b = tiled_case(M, K, N, 0.5, None, dtype, seed=M + bk)
            a[:bm, :bk] = 0
            got, gated = kz.zvg_matmul_cuda(a, b, bm, 128, bk)
            want, want_gated = ref.zvg_matmul_ref(a, b, bm, bk)
            torch.cuda.synchronize()
            err = tiled_error(got, want)
            if not (torch.equal(gated, want_gated)
                    and err <= TILED_TOL[dtype]):
                raise AssertionError(f"K7 at blocks ({bm}, {bk}) {dtype}: "
                                     f"map equal "
                                     f"{torch.equal(gated, want_gated)}, "
                                     f"error {err!r}")
            out["k7_blocks"].append({"M": M, "K": K, "N": N, "bm": bm,
                                     "bk": bk, "dtype": str(dtype),
                                     "rel_err": err})
    gen = torch.Generator(device="cuda").manual_seed(6)
    for M in (4, 8, 9):
        for wdt in (torch.int8, torch.bfloat16, torch.float32):
            K, N = 1024, 1024
            x = torch.randint(-128, 128, (M, K), generator=gen,
                              device="cuda", dtype=torch.int8)
            x[1] = 0
            w = (torch.randint(-128, 128, (K, N), generator=gen,
                               device="cuda", dtype=torch.int8)
                 if wdt == torch.int8 else
                 (torch.randn(K, N, generator=gen, device="cuda")
                  * K ** -0.5).to(wdt))
            got = kz.gated_row_matmul_cuda(x, w)
            plain = ref.gated_row_matmul_ref(x, w)
            torch.cuda.synchronize()
            ctx = f"K2 int8 x {wdt} {M}x{K}x{N}"
            if got.dtype != plain.dtype or got[1].float().abs().max() != 0:
                raise AssertionError(f"{ctx}: dtype {got.dtype} or a "
                                     f"gated row not zero")
            if wdt == torch.int8:   # PRODUCT_TOL[int8]: exact
                if not torch.equal(got, plain):
                    raise AssertionError(f"{ctx}: differs from x @ w mod "
                                         f"256")
                e = 0.0
            else:
                e = check_product(got, plain, x, w, ctx)
            out["k2_int8"].append({"M": M, "w": str(wdt), "max_abs_err": e})
    for K in (40000, 65536):
        x, w = decode_operands(4, K, 256, torch.bfloat16, gen)
        got = kz.gated_row_matmul_cuda(x, w)
        plain = ref.gated_row_matmul_ref(x, w)
        torch.cuda.synchronize()
        e = check_product(got, plain, x, w, f"K2 4x{K}x256")
        out["k2_long_k"].append({"K": K, "splits": kz.decode_plan(
            K, 256, 2).splits, "k_per_split": kz.decode_plan(
            K, 256, 2).k_per_split, "max_abs_err": e})
    log(f"fault 6 closed on the card: K7 at blocks (32, 8), (96, 24), "
        f"(200, 40) and a split (32, 8) in both dtypes, maps equal, max "
        f"relative error {max(r['rel_err'] for r in out['k7_blocks'])!r}; "
        f"K2 int8 with int8, bf16 and f32 at 4, 8, 9 rows (int8 x int8 "
        f"equal); K2 at K = 40000 and 65536 "
        f"({json.dumps(out['k2_long_k'])})")
    return out


def phase_quickstart() -> tuple[dict, int, int]:
    """The quickstart path, ``repro_torch.apps.quickstart.run`` on the
    card with the kernels (each of K1, K5, K6, K7 must launch), then with
    every plain version: equal bus toggles and gated maps, energies and
    savings within rtol 1e-6, products within ``TILED_TOL``. K5 and K6
    are then held bitwise to their plain versions at the path's own
    shape, the weight words ``int32 [512, 128]``: per-lane counts, ``tx``
    and ``inv``. Prints the example's six lines; returns the kernels'
    launches and K5's and K6's largest |kernel - plain| there."""
    from repro_torch.apps import quickstart
    from repro_torch.core.bits import MANT_MASK, to_bits
    from repro_torch.kernels.bic_encode import kernel as k6
    from repro_torch.kernels.bic_encode.ref import bic_encode_ref
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.transitions import kernel as k5
    from repro_torch.kernels.transitions.ref import transitions_ref
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.kernels.zvg_matmul.cases import TILED_TOL, tiled_error

    counted = (k1.fused_counters_cuda, k5.transitions_cuda,
               k6.bic_encode_cuda, kz.zvg_matmul_cuda)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    got = quickstart.run(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    if not all(launches.values()):
        raise AssertionError(f"quickstart launches {launches}: a kernel of "
                             f"the path did not run")
    want = quickstart.run(device="cuda", backend="ref")
    if (got["t_raw"], got["t_enc"]) != (want["t_raw"], want["t_enc"]):
        raise AssertionError(f"weight-bus toggles {got['t_raw']}, "
                             f"{got['t_enc']} != plain {want['t_raw']}, "
                             f"{want['t_enc']}")
    if not torch.equal(got["gated"], want["gated"]):
        raise AssertionError("quickstart: gated maps differ")
    rel = tiled_error(got["out"], want["out"])
    if not rel <= TILED_TOL[torch.bfloat16]:
        raise AssertionError(f"quickstart: product relative error {rel!r}")
    pairs = [(f"power/{d}/{k}", got["power"][d][k], v)
             for d in ("baseline", "proposed")
             for k, v in want["power"][d].items()]
    pairs += [(f"{n}/{k}", got["evaluated"][n]["energy"][k], v)
              for n, r in want["evaluated"].items()
              for k, v in r["energy"].items()]
    pairs += [(f"savings/{n}/{k}", got["savings"][n][k], v)
              for n, r in want["savings"].items() for k, v in r.items()]
    for key, g, w in pairs:
        assert_close(float(g), float(w), f"quickstart {key}")
    if got["best"] != want["best"]:
        raise AssertionError(f"best design {got['best']} != {want['best']}")
    W = torch.from_numpy(quickstart.operands()[1]).to(got["out"].device)
    bits = to_bits(W.to(torch.bfloat16))
    tx, inv = k6.bic_encode_cuda(bits, MANT_MASK)
    want_tx, want_inv = bic_encode_ref(bits, MANT_MASK)
    err6 = word_err((tx, want_tx), (inv, want_inv))
    err5 = word_err(*[(k5.transitions_cuda(x, m), transitions_ref(x, m))
                      for x in (bits, want_tx) for m in (0xFFFF, MANT_MASK)])
    if err5 or err6:
        raise AssertionError(f"quickstart words {tuple(bits.shape)} "
                             f"{bits.dtype}: K5 off by {err5}, K6 by {err6} "
                             f"against the plain versions")
    for line in quickstart.lines(got):
        log(line)
    log(f"quickstart main path on the card: wall {wall:.4f} s, launches "
        f"{json.dumps(launches)}; equal to the "
        f"plain run (toggles {got['t_raw']} -> {got['t_enc']}, gated "
        f"{int(got['gated'].sum())}, product relative error {rel!r}); K5 "
        f"per lane and K6's tx and inv bitwise equal to the plain versions "
        f"on the words {tuple(bits.shape)} {bits.dtype}")
    return launches, err5, err6


def site_words(W: torch.Tensor) -> torch.Tensor:
    """A weight matrix's bf16 words ``[K, N]`` as contiguous uint16."""
    from repro_torch.core.bits import to_bits

    return to_bits(W).to(torch.uint16).contiguous()


def phase_resnet_sites() -> dict:
    """K5, K6 and K7 at full width: every ResNet50 site at 224 px (one
    synthetic image). Per site K6 on the weight words ``[K, N]``, K5 on
    them, on their mantissa field and on K6's ``tx``, K7 on ``(A, W)`` in
    bf16. K5 and K6 are held to K1 (``raw``, ``mant_raw``,
    ``bic/007f/data`` and ``bic/007f/inv`` of the same words) and to their
    plain versions, and K7 to its plain version, on every site. The four
    wrappers' counts are set to 0 before the pass and read after it.
    Returns the operands for the timings, the launches, K5's and K6's
    largest |kernel - plain|, K6's plain time summed over the sites (CUDA
    events around each Python walk) and the gated-tile total."""
    from repro_torch.apps.cnn import analysis, nets
    from repro_torch.core import bic
    from repro_torch.core.bits import MANT_MASK
    from repro_torch.kernels.bic_encode import kernel as k6
    from repro_torch.kernels.bic_encode.ref import bic_encode_ref
    from repro_torch.kernels.power_counters import CounterSpec
    from repro_torch.kernels.power_counters import kernel as k1
    from repro_torch.kernels.transitions import kernel as k5
    from repro_torch.kernels.transitions.ref import transitions_ref
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.kernels.zvg_matmul import ref as zref
    from repro_torch.kernels.zvg_matmul.cases import TILED_TOL, tiled_error

    spec = CounterSpec(bic_variants=(bic.MANTISSA_ONLY,))
    rows = {name: i for i, name in enumerate(spec.rows)}
    key = bic.seg_key(bic.MANTISSA_ONLY)
    images = nets.synthetic_images(1, 224, seed=7, device="cuda")
    traces = nets.forward_with_traces("resnet50", images, seed=0)
    counted = (k1.fused_counters_cuda, k5.transitions_cuda,
               k6.bic_encode_cuda, kz.zvg_matmul_cuda)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sites, gated_sites, tiles, rel7 = [], {}, 0, 0.0
    err5 = err6 = 0
    k6_plain_ms = 0.0
    for t in traces:
        A, W = analysis.matmul_operands(t)
        words = site_words(W)
        a = A.to(torch.bfloat16).contiguous()
        b = W.to(torch.bfloat16).contiguous()
        tx, inv = k6.bic_encode_cuda(words, MANT_MASK)
        raw = k5.transitions_cuda(words)
        mant = k5.transitions_cuda(words, MANT_MASK)
        data = k5.transitions_cuda(tx)
        inv_toggles = (inv ^ torch.cat([torch.zeros_like(inv[:1]),
                                        inv[:-1]])).sum(0, dtype=torch.int32)
        counts, _ = k1.fused_counters_cuda(words, spec)
        for name, got in (("raw", raw), ("mant_raw", mant),
                          (f"bic/{key}/data", data),
                          (f"bic/{key}/inv", inv_toggles)):
            if not torch.equal(got, counts[rows[name]]):
                raise AssertionError(f"ResNet50 {t.name}: K5/K6 toggles != "
                                     f"K1's {name} row")
        start.record()
        want_tx, want_inv = bic_encode_ref(words, MANT_MASK)
        end.record()
        end.synchronize()
        k6_plain_ms += start.elapsed_time(end)
        e5 = word_err((raw, transitions_ref(words)),
                      (mant, transitions_ref(words, MANT_MASK)),
                      (data, transitions_ref(want_tx)))
        e6 = word_err((tx, want_tx), (inv, want_inv))
        if e5 or e6:
            raise AssertionError(f"ResNet50 {t.name}: K5 off its plain "
                                 f"version by {e5}, K6 by {e6}")
        err5, err6 = max(err5, e5), max(err6, e6)
        out, gated = kz.zvg_matmul_cuda(a, b)
        want, want_gated = zref.zvg_matmul_ref(a, b)
        if not torch.equal(gated, want_gated):
            raise AssertionError(f"ResNet50 {t.name}: K7 gated maps differ")
        r = tiled_error(out, want)
        if not r <= TILED_TOL[torch.bfloat16]:
            raise AssertionError(f"ResNet50 {t.name}: K7 relative error "
                                 f"{r!r}")
        rel7 = max(rel7, r)
        if gated.any():
            gated_sites[t.name] = int(gated.sum())
        tiles += gated.numel()
        sites.append((t.name, words, a, b, gated))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    if not all(launches.values()):
        raise AssertionError(f"ResNet50 site pass launches {launches}: a "
                             f"kernel did not run")
    log(f"ResNet50 @ 224 px, {len(sites)} sites at full width, launches "
        f"{json.dumps(launches)}: K5 and K6 toggles equal K1's raw, "
        f"mant_raw, bic/{key}/data and bic/{key}/inv rows on every site; "
        f"K5 and K6 equal their plain versions on every site (K6's plain "
        f"walk {k6_plain_ms:.1f} ms in all); K7's gated maps equal on every "
        f"site, product relative error at most {rel7!r}; K7 gated "
        f"{sum(gated_sites.values())} of {tiles} 128 x 128 tiles, by site "
        f"{json.dumps(gated_sites)}")
    return {"sites": sites, "launches": launches, "err5": err5,
            "err6": err6, "k6_plain_ms": k6_plain_ms,
            "gated_tiles": sum(gated_sites.values()),
            "gated_by_site": gated_sites, "tiles": tiles, "rel_err": rel7}


def tiled_cost(a: torch.Tensor, b: torch.Tensor,
               gated: torch.Tensor) -> tuple[float, float]:
    """The least time K7 could take on an H100 (ms): its bytes (a and b
    read once, the float32 product and the map written once) and the
    operations of the live tiles only (2 per multiply-accumulate, at the
    bf16 tensor-core rate)."""
    (M, K), N = a.shape, b.shape[1]
    bm = bk = 128
    live = 0
    for mb, kb in (gated == 0).nonzero().tolist():
        live += min(bm, M - mb * bm) * min(bk, K - kb * bk)
    nbytes = (a.element_size() * M * K + b.element_size() * K * N
              + 4 * M * N + 4 * gated.numel())
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * live * N / BF16_OPS_PER_S * 1e3


def library_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes K7's product (bf16 operands, a
    float32 result), K7's yardstick; the port never calls it."""
    return torch.mm(a, b, out_dtype=torch.float32)


def phase_stream_timing(site_pass: dict) -> dict:
    """K5 and K6 summed over the 54 ResNet50 weight streams, K7 summed
    over the 54 sites and once at the quickstart shape, each beside its
    plain version, its bound and (K7) the library call. K5 and K6: device
    time per launch from the profiler (:func:`device_ms`), summed (their
    launches are a few microseconds, which host gaps would swamp); K6's
    plain version, a Python walk of some 55 k steps, as the site pass
    timed it. K7, its
    plain version and the library call by CUDA events, cycling through
    the sites (:func:`time_cycle`; the profiler missed the library call's
    kernels at the quickstart shape), K7 also by the profiler; K6 alone
    on the largest stream by CUDA events over 5 launches."""
    from repro_torch.apps import quickstart
    from repro_torch.core.bits import MANT_MASK
    from repro_torch.kernels.bic_encode import kernel as k6
    from repro_torch.kernels.transitions import kernel as k5
    from repro_torch.kernels.transitions.ref import transitions_ref
    from repro_torch.kernels.zvg_matmul import kernel as kz
    from repro_torch.kernels.zvg_matmul import ref as zref

    sites = site_pass["sites"]
    n = len(sites)
    lib_name, lib = "torch.mm(a, b, out_dtype=torch.float32)", library_matmul
    words = [w for _, w, _, _, _ in sites]
    t5 = {"ms": n * device_ms([lambda w=w: k5.transitions_cuda(w)
                               for w in words]),
          "plain_ms": n * device_ms([lambda w=w: transitions_ref(w)
                                     for w in words]),
          "bytes_ms": sum(2 * w.numel() + 4 * w.shape[1] for w in words)
          / HBM_BYTES_PER_S * 1e3,
          "ops_ms": sum(3 * w.numel() for w in words) / ALU_OPS_PER_S * 1e3}
    t6 = {"ms": n * device_ms([lambda w=w: k6.bic_encode_cuda(w, MANT_MASK)
                               for w in words]),
          "plain_ms": site_pass["k6_plain_ms"],
          "bytes_ms": sum(5 * w.numel() for w in words)
          / HBM_BYTES_PER_S * 1e3,
          "ops_ms": sum(4 * w.numel() for w in words) / ALU_OPS_PER_S * 1e3}
    ops7 = [(a, b) for _, _, a, b, _ in sites]
    kern7 = [lambda a=a, b=b: kz.zvg_matmul_cuda(a, b) for a, b in ops7]
    t7 = {"ms": n * time_cycle(kern7, 3),
          "plain_ms": n * time_cycle([lambda a=a, b=b: zref.zvg_matmul_ref(
              a, b) for a, b in ops7], 3),
          "library_ms": n * time_cycle([lambda a=a, b=b: lib(a, b)
                                        for a, b in ops7], 3),
          "profiler_ms": n * device_ms(kern7),
          "bytes_ms": 0.0, "ops_ms": 0.0}
    for _, _, a, b, gated in sites:
        b_ms, o_ms = tiled_cost(a, b, gated)
        t7["bytes_ms"] += b_ms
        t7["ops_ms"] += o_ms
    A, W = (torch.from_numpy(v).to(words[0].device).to(torch.bfloat16)
            for v in quickstart.operands())
    _, qgated = kz.zvg_matmul_cuda(A, W)
    qb, qo = tiled_cost(A, W, qgated)
    t7["quickstart"] = {
        "M": A.shape[0], "K": A.shape[1], "N": W.shape[1],
        "ms": time_ms(lambda: kz.zvg_matmul_cuda(A, W), 20),
        "plain_ms": time_ms(lambda: zref.zvg_matmul_ref(A, W), 20),
        "library_ms": time_ms(lambda: lib(A, W), 20),
        "bound_ms": max(qb, qo)}
    t7["library"] = lib_name
    for name, t in (("transitions", t5), ("bic_encode", t6),
                    ("zvg_matmul", t7)):
        bound = max(t["bytes_ms"], t["ops_ms"])
        log(f"{name} summed over the {n} ResNet50 sites, ms: kernel "
            f"{t['ms']:.4f}, plain {t['plain_ms']:.4f}"
            + (f", {lib_name} {t['library_ms']:.4f}" if "library_ms" in t
               else "") + f", bound {bound:.5f}")
    q = t7["quickstart"]
    log(f"zvg_matmul summed over the sites by the profiler: "
        f"{t7['profiler_ms']:.4f} ms")
    log(f"zvg_matmul at the quickstart shape {q['M']}x{q['K']}x{q['N']} "
        f"(bf16), ms by CUDA events: kernel {q['ms']:.5f}, plain "
        f"{q['plain_ms']:.5f}, {lib_name} {q['library_ms']:.5f}, bound "
        f"{q['bound_ms']:.6f}")
    # the five sites where K7 takes longest (device time, profiler), each
    # beside the library call at that site
    per_site = sorted(
        ((device_ms([lambda a=a, b=b: kz.zvg_matmul_cuda(a, b)] * 3), name,
          a, b) for name, _, a, b, _ in sites), key=lambda t: -t[0])[:5]
    t7["slowest"] = [
        {"site": name, "M": a.shape[0], "K": a.shape[1], "N": b.shape[1],
         "splits": kz.tiled_plan(a.shape[0], a.shape[1], b.shape[1], 128,
                                 128).splits, "ms": ms,
         "library_ms": device_ms([lambda a=a, b=b: lib(a, b)] * 3)}
        for ms, name, a, b in per_site]
    for t in t7["slowest"]:
        log(f"zvg_matmul slowest site {t['site']} {t['M']}x{t['K']}x"
            f"{t['N']} ({t['splits']} splits), device ms: kernel "
            f"{t['ms']:.4f}, {lib_name} {t['library_ms']:.4f}")
    big = max(sites, key=lambda s: s[1].shape[0])
    t6["largest"] = {"site": big[0], "T": big[1].shape[0],
                     "L": big[1].shape[1],
                     "ms": time_ms(lambda: k6.bic_encode_cuda(
                         big[1], MANT_MASK), 5)}
    big5 = max(sites, key=lambda s: s[1].numel())
    t5["largest"] = {
        "site": big5[0], "T": big5[1].shape[0], "L": big5[1].shape[1],
        "ms": device_ms([lambda: k5.transitions_cuda(big5[1])] * 5),
        "events_ms": time_ms(lambda: k5.transitions_cuda(big5[1]), 20),
        "plan": k5.transitions_plan(*big5[1].shape, 2).__dict__}
    log(f"transitions on the largest weight stream {big5[0]} "
        f"{tuple(big5[1].shape)}: device {t5['largest']['ms']:.5f} ms "
        f"(profiler), {t5['largest']['events_ms']:.5f} ms by CUDA events, "
        f"plan {t5['largest']['plan']}")
    return {"k5": t5, "k6": t6, "k7": t7}


def time_ms(fn, reps: int) -> float:
    return time_cycle([fn], reps)


def time_cycle(fns, reps: int) -> float:
    """Mean ms per call of ``fns`` run in turn ``reps`` times (CUDA
    events). Cycling through a main path's distinct weights keeps them
    out of the 50 MB L2 cache, as one decode step finds them. Python's
    garbage collector is held off inside the window: a collection of
    this process's large heap would land on whichever call is timed."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    gc.collect()
    gc.disable()
    try:
        start.record()
        for _ in range(reps):
            for fn in fns:
                fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return start.elapsed_time(end) / (reps * len(fns))


def device_ms(fns, by_kernel: bool = False):
    """Mean device time per call of ``fns`` run once each: the durations
    of the kernels they launch, from ``torch.profiler`` (CUPTI). Unlike
    :func:`time_cycle` it leaves out the gaps where the card waits for
    the host, which set the time of a stream of small launches. With
    ``by_kernel``, also each kernel's share by name (the last ``::`` part
    of its name before any template arguments)."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    names: dict[str, float] = {}
    # a profile that delivers no device events at all (CUPTI does, rarely,
    # over the dozens of profiles a run takes) is taken once more
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                fn()
            torch.cuda.synchronize()
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                key = evt.name.split("<")[0].split("::")[-1].split("(")[0]
                key = key.strip() or evt.name[:40]
                names[key] = names.get(key, 0.0) + evt.time_range.elapsed_us()
        if names:
            break
    total = sum(names.values())
    if not total:
        raise AssertionError("the profiler saw no device time")
    if by_kernel:
        return total / 1e3 / len(fns), {k: v / 1e3 / len(fns)
                                        for k, v in names.items()}
    return total / 1e3 / len(fns)


def launch_cost(x: torch.Tensor, spec) -> tuple[float, float]:
    """The least time one launch could take on an H100 (ms), from the
    bytes it must move (each 16-bit bus word read once, whatever dtype
    carries it, every counter and rowzeros written once) and its integer
    work (one accumulate per counter row per word, against the float32
    non-tensor peak)."""
    B = x.shape[0] if x.dim() == 3 else 1
    T, L = x.shape[-2:]
    nbytes = 2 * x.numel() + 4 * B * (spec.n_rows * L + T)
    ops = x.numel() * spec.n_rows
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / ALU_OPS_PER_S * 1e3


def k1_shapes(sites, msites) -> list:
    """The launches of :data:`K1_PLAN_SHAPES` as ``(label, words,
    spec)``: the CNN main paths' own streams (``sites`` and ``msites`` as
    :func:`check_sites` returns them), and for the serving accountant's
    prefill edges random words of that shape, a third of them zero, under
    the CNN menu's specs."""
    streams = {}
    for net, ss in (("resnet50", sites), ("mobilenet", msites)):
        for name, a, ws, b, ns in ss:
            streams[f"{net} {name} west"] = (a, ws)
            streams[f"{net} {name} north"] = (b, ns)
    _, a, wspec, _, nspec = sites[0]
    gen = torch.Generator(device=a.device).manual_seed(0)
    out = []
    for label, (B, T, L) in K1_PLAN_SHAPES.items():
        if label.startswith("prefill"):
            x = torch.randint(0, 1 << 16, (T, L), generator=gen,
                              device=a.device, dtype=torch.int32)
            x[torch.rand(x.shape, generator=gen, device=a.device)
              < 1 / 3] = 0
            x, spec = x.to(a.dtype), (wspec if "west" in label else nspec)
        else:
            x, spec = streams[label]
        shape = tuple(x.shape) if x.dim() == 3 else (1, *x.shape)
        if shape != (B, T, L):
            raise AssertionError(f"K1 launch {label}: {shape} is not "
                                 f"{(B, T, L)}")
        out.append((label, x, spec))
    return out


def phase_timing(sites, msites) -> dict:
    """K1 over the CNN main paths' launches, ResNet50's 108 and
    MobileNetV1's 56: device time per launch from the profiler
    (:func:`device_ms`) and by CUDA events cycling through the launches
    (which the host's ~25-40 us a call sets), summed, beside the plain
    version (events) and the bound; and each launch of
    :func:`k1_shapes` alone (profiler) with its plan."""
    from repro_torch.kernels.power_counters.kernel import (counter_plan,
                                                           fused_counters_cuda)
    from repro_torch.kernels.power_counters.ref import fused_counters_ref

    out = {}
    for net, ss in (("resnet50", sites), ("mobilenet", msites)):
        launches = [(x, spec) for _, a, ws, b, ns in ss
                    for x, spec in ((a, ws), (b, ns))]
        fns = [lambda x=x, s=s: fused_counters_cuda(x, s)
               for x, s in launches]
        n = len(fns)
        t = {"launches": n, "ms": n * device_ms(fns),
             "events_ms": n * time_cycle(fns, 5),
             "plain_ms": n * time_cycle([
                 lambda x=x, s=s: fused_counters_ref(x, s)
                 for x, s in launches], 2),
             "bytes_ms": 0.0, "ops_ms": 0.0}
        for x, spec in launches:
            b_ms, o_ms = launch_cost(x, spec)
            t["bytes_ms"] += b_ms
            t["ops_ms"] += o_ms
        out[net] = t
    shapes = []
    for label, x, spec in k1_shapes(sites, msites):
        b_ms, o_ms = launch_cost(x, spec)
        plan = counter_plan(*((1,) * (3 - x.dim()) + tuple(x.shape)))
        shapes.append({
            "launch": label, "shape": list(x.shape), "n_rows": spec.n_rows,
            "route": plan.route, "plan": plan.__dict__,
            "ms": device_ms([lambda: fused_counters_cuda(x, spec)] * 5),
            "plain_ms": time_ms(lambda: fused_counters_ref(x, spec), 3),
            "bound_ms": max(b_ms, o_ms)})
        log(f"power_counters {label} {tuple(x.shape)} ({plan.route}, "
            f"{plan.chunks} chunks of {plan.chunk}): device "
            f"{shapes[-1]['ms']:.5f} ms, plain {shapes[-1]['plain_ms']:.4f}"
            f" ms, bound {shapes[-1]['bound_ms']:.6f} ms")
    out["shapes"] = shapes
    return out


def phase_serving_timing(cfg, eng) -> dict:
    """K2 and K3 at the serving main path's shapes and operands, beside
    their plain versions, the one PyTorch call that computes K2's
    function (``torch.matmul``) and their bounds: device time from the
    profiler (:func:`device_ms`) and, for the kernels, CUDA events over
    many launches (:func:`time_cycle`); then the warm decode step on the
    host clock, with each backend."""
    from repro_torch.kernels.zvg_matmul import kernel, ref
    from repro_torch.models import lm
    from repro_torch.serve.power import _decode_menu, _subsample_decode

    W = eng.weights
    M = SERVE_SLOTS
    gen = torch.Generator(device="cuda").manual_seed(2)
    groups = {
        "wq wk wv wo": [l["mixer"][n] for l in W["layers"]
                        for n in ("wq", "wk", "wv", "wo")],
        "ffn up gate": [l["ffn"][n] for l in W["layers"]
                        for n in ("up", "gate")],
        "ffn down": [l["ffn"]["down"] for l in W["layers"]],
        "lm head": [W["head"]],
    }
    k2 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "events_ms": 0.0,
          "bytes_ms": 0.0, "ops_ms": 0.0, "launches": 0, "shapes": []}
    with torch.no_grad():
        for name, ws in groups.items():
            K, N = ws[0].shape
            x = torch.randn(M, K, generator=gen, device="cuda").to(
                torch.bfloat16)
            kern = [lambda w=w: kernel.gated_row_matmul_cuda(x, w)
                    for w in ws]
            plain = [lambda w=w: ref.gated_row_matmul_ref(x, w) for w in ws]
            lib = [lambda w=w: torch.matmul(x, w) for w in ws]
            t = {"ms": device_ms(kern), "plain_ms": device_ms(plain),
                 "library_ms": device_ms(lib),
                 "events_ms": time_cycle(kern, 5 if len(ws) > 1 else 20),
                 "bytes_ms": 2 * (M * K + K * N + M * N)
                 / HBM_BYTES_PER_S * 1e3,
                 "ops_ms": 2 * M * K * N / BF16_OPS_PER_S * 1e3}
            n = len(ws)
            for key, v in t.items():
                k2[key] += n * v
            k2["launches"] += n
            bound_ms = max(t["bytes_ms"], t["ops_ms"])
            k2["shapes"].append({"weights": name, "M": M, "K": K, "N": N,
                                 "per_step": n, "ms": t["ms"],
                                 "plain_ms": t["plain_ms"],
                                 "library_ms": t["library_ms"],
                                 "events_ms": t["events_ms"],
                                 "bound_ms": bound_ms})
            log(f"gated_row_matmul {M}x{K}x{N} ({name}, {n} per decode "
                f"step), device ms per launch: kernel {t['ms']:.4f}, plain "
                f"{t['plain_ms']:.4f}, torch.matmul {t['library_ms']:.4f}, "
                f"bound {bound_ms:.5f}; kernel by CUDA events "
                f"{t['events_ms']:.4f}")
        log(f"gated_row_matmul per decode step ({k2['launches']} launches),"
            f" device ms: kernel {k2['ms']:.4f}, plain {k2['plain_ms']:.4f},"
            f" torch.matmul {k2['library_ms']:.4f}, bound "
            f"{max(k2['bytes_ms'], k2['ops_ms']):.4f}; kernel by CUDA "
            f"events {k2['events_ms']:.4f}")
        # the same shapes at the paged step's 8 rows
        k2["rows_8"] = {"ms": 0.0, "library_ms": 0.0, "shapes": []}
        for name, ws in groups.items():
            K, N = ws[0].shape
            x = torch.randn(PAGED_ROWS, K, generator=gen, device="cuda").to(
                torch.bfloat16)
            ms = device_ms([lambda w=w: kernel.gated_row_matmul_cuda(x, w)
                            for w in ws])
            lib_ms = device_ms([lambda w=w: torch.matmul(x, w) for w in ws])
            k2["rows_8"]["ms"] += len(ws) * ms
            k2["rows_8"]["library_ms"] += len(ws) * lib_ms
            k2["rows_8"]["shapes"].append({
                "weights": name, "M": PAGED_ROWS, "K": K, "N": N,
                "per_step": len(ws), "ms": ms, "library_ms": lib_ms,
                "bound_ms": 2 * (PAGED_ROWS * K + K * N + PAGED_ROWS * N)
                / HBM_BYTES_PER_S * 1e3})
            log(f"gated_row_matmul {PAGED_ROWS}x{K}x{N} ({name}), device ms "
                f"per launch: kernel {ms:.4f}, torch.matmul {lib_ms:.4f}")
        log(f"gated_row_matmul per decode step at {PAGED_ROWS} rows, device "
            f"ms: kernel {k2['rows_8']['ms']:.4f}, torch.matmul "
            f"{k2['rows_8']['library_ms']:.4f}")

        # K3 on the accountant's operands: the embedded decode inputs and
        # the monitored weights, sub-sampled as record_decode does
        mcfg = eng.accountant.mcfg
        geom, _, wspec, nspec = _decode_menu(mcfg)
        tokens = torch.randint(0, cfg.vocab, (M, 1), generator=gen,
                               device="cuda")
        x = eng._embed(eng._embed_bf16, tokens)[:, 0]
        ops3 = [_subsample_decode(x, w, mcfg) for _, w in eng._power_weights]
        args = [(a, w, wspec, nspec, geom.rows, geom.cols) for a, w in ops3]
        kern3 = [lambda a=a: kernel.fused_matmul_counters_cuda(*a)
                 for a in args]
        ms3, parts3 = device_ms(kern3, by_kernel=True)
        events3 = time_cycle(kern3, 20)
        plain3 = device_ms([lambda a=a: ref.fused_matmul_counters_ref(*a)
                            for a in args])
        # K2 alone at K3's product shape, on the same operands
        k2_at3 = device_ms([lambda a=a, w=w: kernel.gated_row_matmul_cuda(
            a, w) for a, w in ops3])
        a, w = ops3[0]
        B, K = a.shape
        N = w.shape[1]
        Np = -(-N // geom.cols) * geom.cols
        nbytes = (a.element_size() * B * K + w.element_size() * K * N
                  + 4 * (B * N + B * wspec.n_rows * geom.rows + B * K
                         + nspec.n_rows * Np + K))
        ops = (2 * B * K * N + B * K * geom.rows * wspec.n_rows
               + K * Np * nspec.n_rows)
        k3 = {"ms": ms3, "plain_ms": plain3, "events_ms": events3,
              "ms_by_kernel": parts3, "k2_at_product_shape_ms": k2_at3,
              "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "ops_ms": ops / ALU_OPS_PER_S * 1e3,
              "shape": {"B": B, "K": K, "N": N, "lanes_w": geom.rows,
                        "lanes_n": Np, "a": str(a.dtype), "w": str(w.dtype)}}
        log(f"fused_matmul_counters {B}x{K}x{N} ({a.dtype} x {w.dtype}), "
            f"device ms per launch: kernel {ms3:.4f}, plain {plain3:.4f}, "
            f"bound {max(k3['bytes_ms'], k3['ops_ms']):.5f}; kernel by "
            f"CUDA events {events3:.4f}; by kernel "
            f"{json.dumps({k: round(v, 5) for k, v in parts3.items()})}; "
            f"gated_row_matmul alone at the product's shape {k2_at3:.5f}")

        # the accountant's whole sampled-step work, host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            xe = eng._embed(eng._embed_bf16, tokens)[:, 0]
            for site, w in eng._power_weights:
                eng.accountant.record_decode([], xe, w, site)
        torch.cuda.synchronize()
        acct_ms = (time.perf_counter() - t0) / 10 * 1e3

        # the warm decode step (the model alone), host clock
        states = lm.make_decode_state(cfg, M, SERVE_CACHE, torch.bfloat16,
                                      "cuda")
        positions = torch.full((M, 1), SERVE_CACHE // 2, device="cuda")
        step_ms = {}
        for backend in ("auto", "ref"):
            decode = lm.make_decode_step(cfg, backend)
            decode(W, states, tokens, positions)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                decode(W, states, tokens, positions)
            torch.cuda.synchronize()
            step_ms[backend] = (time.perf_counter() - t0) / 10 * 1e3
    out = {"k2": k2, "k3": k3, "decode_step_ms": step_ms,
           "accounting_ms": acct_ms,
           "tokens_per_s": M / step_ms["auto"] * 1e3,
           "k2_share": k2["ms"] / step_ms["auto"]}
    log(f"warm decode step ({M} rows, model only): {step_ms['auto']:.3f} ms "
        f"with the kernels ({out['tokens_per_s']:.1f} tok/s, "
        f"gated_row_matmul {out['k2_share'] * 100:.1f}% of it), "
        f"{step_ms['ref']:.3f} ms with the plain versions; the power "
        f"accountant's sampled-step work (embedding + 2 x record_decode): "
        f"{acct_ms:.3f} ms")
    return out


def profile_once(name: str, work) -> dict | None:
    """One warm call of ``work`` under ``torch.profiler``: each kernel's
    own device time by name, and the device's busy share of the profiled
    window (host clock)."""
    from torch.profiler import ProfilerActivity, profile

    work()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(evt.name, []).append(
                evt.time_range.elapsed_us())
    if not kernels:
        log(f"{name}: the profiler saw no device events; device time by "
            f"kernel not measured")
        return None
    busy = sum(sum(v) for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:6]
    log(f"{name} profiled: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({busy / wall_us * 100:.1f}%); "
        + "; ".join(f"{k[:48]} x{len(v)} {sum(v) / 1e3:.4f} ms"
                    for k, v in top))
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "kernels": {k[:60]: {"launches": len(v), "ms": sum(v) / 1e3}
                        for k, v in top}}


def phase_decode_profile(cfg, eng) -> dict:
    """One warm slot decode step and one accountant step under
    :func:`profile_once`."""
    from repro_torch.models import lm

    M = SERVE_SLOTS
    W = eng.weights
    states = lm.make_decode_state(cfg, M, SERVE_CACHE, torch.bfloat16,
                                  "cuda")
    tokens = torch.zeros((M, 1), dtype=torch.long, device="cuda")
    positions = torch.full((M, 1), SERVE_CACHE // 2, device="cuda")
    decode = lm.make_decode_step(cfg, "auto")
    out = {}
    with torch.no_grad():
        for name, work in (
                ("decode step", lambda: decode(W, states, tokens,
                                               positions)),
                ("accountant step", lambda: [
                    eng.accountant.record_decode(
                        [], eng._embed(eng._embed_bf16, tokens)[:, 0], w,
                        site) for site, w in eng._power_weights])):
            got = profile_once(name, work)
            if got is not None:
                out[name] = got
    return out


def phase_paged_timing(cfg, eng, reqs) -> dict:
    """K4 at the paged serving path's shapes: 8 rows whose lengths are
    run (b)'s first 8 prompts plus 16 decoded tokens, sharing the 4
    system-prompt pages, over 24 layers' pools of 129 pages (random
    bfloat16). Device time per launch by the profiler beside the plain
    version, the gather + ``scaled_dot_product_attention`` yardstick and
    the bound; then the warm paged decode step on the host clock, with
    each backend, and its profile."""
    import torch.nn.functional as F

    from repro_torch.kernels.zvg_matmul import kernel, ref
    from repro_torch.kernels.zvg_matmul.cases import PAGED_CASES, paged_case
    from repro_torch.models import lm
    from repro_torch.models.attention import decode_attention

    gen = torch.Generator(device="cuda").manual_seed(4)
    B, mp = PAGED_ROWS, SERVE_CACHE // PAGE
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lengths = [len(r["prompt"]) + 16 for r in reqs[:B]]
    n_sys = PAGED_SYSTEM // PAGE
    tables, nxt = [], 1 + n_sys
    for n in lengths:
        own = -(-n // PAGE) - n_sys
        row = list(range(1, 1 + n_sys)) + list(range(nxt, nxt + own))
        nxt += own
        tables.append(row + [0] * (mp - len(row)))
    pages = torch.tensor(tables, dtype=torch.int32, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    pools = [(torch.randn(129, PAGE, kv, hd, generator=gen, device="cuda"
                          ).to(torch.bfloat16),
              torch.randn(129, PAGE, kv, hd, generator=gen, device="cuda"
                          ).to(torch.bfloat16)) for _ in range(cfg.n_layers)]
    q = torch.randn(B, 1, h, hd, generator=gen, device="cuda").to(
        torch.bfloat16)
    mask = (torch.arange(mp * PAGE, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None, :]

    def yardstick(kp, vp):
        k = ref.gather_pages(kp, pages).transpose(1, 2)
        v = ref.gather_pages(vp, pages).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                              attn_mask=mask)

    with torch.no_grad():
        kern = [lambda p=p: kernel.fused_paged_attention_cuda(q, *p, pages,
                                                              lens)
                for p in pools]
        t = {"ms": device_ms(kern),
             "plain_ms": device_ms([lambda p=p: ref.fused_paged_attention_ref(
                 q, *p, pages, lens, decode_attention) for p in pools]),
             "yardstick_ms": device_ms([lambda p=p: yardstick(*p)
                                        for p in pools]),
             "events_ms": time_cycle(kern, 20),
             "bytes_ms": paged_attention_bytes(pools[0][0], q, pages, lens)
             / HBM_BYTES_PER_S * 1e3,
             "ops_ms": 4 * sum(lengths) * h * hd / ALU_OPS_PER_S * 1e3}
        # the PAGED_CASES case of rep 8, hd 128 (bf16)
        case = next(c for c in PAGED_CASES if c[2] == 8 and c[3] == 128)
        q8, kp8, vp8, pg8, ln8 = paged_case(*case[:6], torch.bfloat16,
                                            seed=0)
        t["rep8_hd128"] = {
            "case": case, "plan": kernel.paged_plan(
                case[5], case[4], case[0], case[1]).__dict__,
            "ms": device_ms([lambda: kernel.fused_paged_attention_cuda(
                q8, kp8, vp8, pg8, ln8, softcap=case[6])] * 3)}
        log(f"fused_paged_attention at the rep-8, hd-128 case {case}: "
            f"device ms per launch {t['rep8_hd128']['ms']:.5f}")
        per_step = cfg.n_layers
        bound = max(t["bytes_ms"], t["ops_ms"])
        log(f"fused_paged_attention {B} rows x {h} heads x hd {hd}, lengths "
            f"{lengths} (ps {PAGE}, bf16), device ms per launch: kernel "
            f"{t['ms']:.5f}, plain {t['plain_ms']:.5f}, gather + sdpa "
            f"{t['yardstick_ms']:.5f}, bound {bound:.6f}; kernel by CUDA "
            f"events {t['events_ms']:.5f}; per decode step ({per_step} "
            f"launches) kernel {t['ms'] * per_step:.4f} ms, bound "
            f"{bound * per_step:.5f} ms")

        W = eng.weights
        tokens = torch.zeros((B, 1), dtype=torch.long, device="cuda")
        positions = (lens - 1).long()[:, None]
        step_ms = {}
        for backend in ("auto", "ref"):
            decode = lm.make_decode_step(cfg, backend)
            decode(W, pools, tokens, positions, pages)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                decode(W, pools, tokens, positions, pages)
            torch.cuda.synchronize()
            step_ms[backend] = (time.perf_counter() - t0) / 10 * 1e3
        decode = lm.make_decode_step(cfg, "auto")
        profiled = profile_once("paged decode step", lambda: decode(
            W, pools, tokens, positions, pages))
    t.update(launches_per_step=per_step, lengths=lengths,
             shape={"B": B, "h": h, "kv": kv, "hd": hd, "ps": PAGE,
                    "mp": mp, "dtype": "bfloat16"},
             decode_step_ms=step_ms, tokens_per_s=B / step_ms["auto"] * 1e3,
             profiled=profiled)
    log(f"warm paged decode step ({B} rows, model only): "
        f"{step_ms['auto']:.3f} ms with the kernels "
        f"({t['tokens_per_s']:.1f} tok/s), {step_ms['ref']:.3f} ms with the "
        f"plain versions")
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch import design as D
    from repro_torch.kernels import _build
    from repro_torch.kernels.zvg_matmul.cases import ATTN_TOL, TILED_TOL

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"built {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in paths:
        ptxas = [l.strip() for l in
                 (_build.BUILD / f"{name}.log").read_text().splitlines()
                 if "registers" in l or "spill" in l]
        log(f"ptxas {name}: " + " | ".join(ptxas[:8]))
    for name, kernels in REDESIGNED.items():
        for line in ptxas_summary(name, kernels):
            log(f"ptxas {name}: {line}")
    sass_check(paths["zvg_tiled_matmul"])
    log_plans()

    err = phase_kernel_cases()
    err2, err3 = phase_decode_kernel_cases()
    rel4, err4, fault4 = phase_paged_kernel_cases()
    err5, err6 = phase_stream_kernel_cases()
    rel7, err7 = phase_tiled_kernel_cases()
    fault6 = phase_fault6()
    designs = tuple(D.named_designs().values())
    layers, launches, _ = run_main_path("resnet50", designs, 54)
    sites, e = check_sites("resnet50", layers, designs)
    err = max(err, e)
    mlayers, mlaunches, _ = run_main_path("mobilenet", designs, 28)
    msites, e = check_sites("mobilenet", mlayers, designs)
    err = max(err, e)
    cfg, params, eng, slot_done, serve_launches = phase_serving()
    paged = phase_paged_serving(cfg, params, eng, slot_done)
    telemetry = phase_telemetry(cfg, params)
    quick_launches, e5, e6 = phase_quickstart()
    site_pass = phase_resnet_sites()
    err5 = max(err5, e5, site_pass["err5"])
    err6 = max(err6, e6, site_pass["err6"])
    site_launches = site_pass["launches"]
    traces = phase_trace()
    sweep, sweep_sites = phase_sweep()
    zoo = phase_zoo()
    zoo_serving = phase_zoo_serving()

    breakdown = phase_breakdown("resnet50", designs)
    k1 = phase_timing(sites, msites)
    tot = k1["resnet50"]
    for net in ("resnet50", "mobilenet"):
        t = k1[net]
        log(f"power_counters over the {net} main path's {t['launches']} "
            f"launches: device {t['ms']:.4f} ms (profiler), events "
            f"{t['events_ms']:.4f} ms, plain version {t['plain_ms']:.3f} ms,"
            f" bound {max(t['bytes_ms'], t['ops_ms']):.5f} ms")
    st = phase_serving_timing(cfg, eng)
    k2, k3 = st["k2"], st["k3"]
    profiled = phase_decode_profile(cfg, eng)
    k4 = phase_paged_timing(cfg, paged["engine"], paged_requests(cfg.vocab))
    stream = phase_stream_timing(site_pass)
    k5, k6, k7 = stream["k5"], stream["k6"], stream["k7"]
    train = phase_train()
    phase_sweep_busy(sweep, sweep_sites)
    phase_trace_busy(traces)
    phase_train_busy(train)
    bench = phase_bench(layers, mlayers)
    n_sites = len(site_pass["sites"])

    from repro_torch.kernels.zvg_matmul import kernel as kz
    kz_plan = kz.paged_plan(SERVE_CACHE // PAGE, PAGE, PAGED_ROWS,
                            cfg.n_kv_heads).__dict__

    def bound(t):
        return {"bound_ms": max(t["bytes_ms"], t["ops_ms"]),
                "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                             else "operations")}

    log(json.dumps({"kernels": [{
        "name": "power_counters",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "launches_mobilenet": mlaunches,
        "launches_serving": serve_launches["fused_counters_cuda"],
        "max_abs_err": err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        **bound(tot),
        "library_ms": None,
        "events_ms": tot["events_ms"],
        "ms_over": "one launch on each of the ResNet50 main path's 108 "
                   "edge streams, device time (profiler), summed; "
                   "events_ms by CUDA events cycling through them, "
                   "plain_ms likewise",
        "mobilenet": {k: k1["mobilenet"][k] for k in (
            "launches", "ms", "events_ms", "plain_ms")} | bound(
                k1["mobilenet"]),
        "counting_s": breakdown["counters_s"],
        "shapes": k1["shapes"],
        "launches_trace": {k: v["launches"]["fused_counters_cuda"]
                           for k, v in traces.items() if k != "sweep"},
        "traces": traces,
        "launches_design_sweep": sweep["launches"],
        "design_sweep": sweep,
        "launches_zoo": {a: {m: z[m]["launches"]["fused_counters_cuda"]
                             for m in ("forward", "decode")}
                         for a, z in zoo.items()},
        "launches_zoo_serving": zoo_launches(zoo_serving,
                                             "fused_counters_cuda"),
        "launches_telemetry": telemetry_launches(telemetry,
                                                 "fused_counters_cuda"),
        "launches_train": train["a"]["k1_launches"],
        "train": train,
        "launches_bench": bench["launches"]["fused_counters_cuda"],
        "bench": bench,
    }, {
        "name": "gated_row_matmul",
        "route": "cuda",
        "source": ZVG_SOURCE,
        "replaces": K2_REPLACES,
        "launches": serve_launches["gated_row_matmul_cuda"],
        "launches_paged_b": paged["b"]["launches_all"][
            "gated_row_matmul_cuda"],
        "launches_trace_decode": traces["qwen1.5-0.5b decode"]["launches"][
            "gated_row_matmul_cuda"],
        "launches_zoo_decode": {
            a: z["decode"]["launches"]["gated_row_matmul_cuda"]
            for a, z in zoo.items()},
        "launches_zoo_serving": zoo_launches(zoo_serving,
                                             "gated_row_matmul_cuda"),
        "launches_telemetry": telemetry_launches(telemetry,
                                                 "gated_row_matmul_cuda"),
        "launches_bench": bench["launches"]["gated_row_matmul_cuda"],
        "zoo": zoo,
        "zoo_serving": zoo_serving,
        "max_abs_err": err2,
        "fault6": {"int8": fault6["k2_int8"], "long_k": fault6["k2_long_k"]},
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        **bound(k2),
        "library_ms": k2["library_ms"],
        "events_ms": k2["events_ms"],
        "ms_over": f"one decode step's {k2['launches']} launches, device "
                   f"time (profiler); events_ms by CUDA events",
        "shapes": k2["shapes"],
        "rows_8": k2["rows_8"],
        "decode_step_ms": st["decode_step_ms"],
        "share_of_decode_step": st["k2_share"],
        "profiled": profiled.get("decode step"),
    }, {
        "name": "fused_matmul_counters",
        "route": "cuda",
        "source": ZVG_SOURCE,
        "replaces": K3_REPLACES,
        "launches": serve_launches["fused_matmul_counters_cuda"],
        "launches_paged_b": paged["b"]["launches_all"][
            "fused_matmul_counters_cuda"],
        "max_abs_err": err3,
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        **bound(k3),
        "library_ms": None,
        "events_ms": k3["events_ms"],
        "ms_over": "one call (two launches: the product and the counter "
                   "walk), device time (profiler); events_ms by CUDA events",
        "launches_zoo_serving": zoo_launches(zoo_serving,
                                             "fused_matmul_counters_cuda"),
        "launches_telemetry": telemetry_launches(
            telemetry, "fused_matmul_counters_cuda"),
        "launches_bench": bench["launches"]["fused_matmul_counters_cuda"],
        "telemetry": telemetry,
        "ms_by_kernel": k3["ms_by_kernel"],
        "k2_at_product_shape_ms": k3["k2_at_product_shape_ms"],
        "shape": k3["shape"],
        "accounting_step_ms": st["accounting_ms"],
        "profiled": profiled.get("accountant step"),
    }, {
        "name": "fused_paged_attention",
        "route": "cuda",
        "source": K4_SOURCE,
        "replaces": K4_REPLACES,
        "launches": paged["b"]["launches"],
        "launches_runs": {k: paged[k]["launches"] for k in "abc"},
        "launches_telemetry": telemetry_launches(
            telemetry, "fused_paged_attention_cuda"),
        "launches_zoo_serving": zoo_launches(zoo_serving,
                                             "fused_paged_attention_cuda"),
        "launches_bench": bench["launches"]["fused_paged_attention_cuda"],
        "decode_steps_runs": {k: paged[k]["decode_steps"] for k in "abc"},
        "max_abs_err": err4,
        "max_rel_err": rel4,
        "rel_tol": {str(d).split(".")[-1]: v for d, v in ATTN_TOL.items()},
        "planted_fault_rel_err": fault4,
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        **bound(k4),
        "library_ms": None,
        "yardstick_ms": k4["yardstick_ms"],
        "yardstick": "gather_pages + F.scaled_dot_product_attention",
        "rep8_hd128": k4["rep8_hd128"],
        "plan": kz_plan,
        "events_ms": k4["events_ms"],
        "ms_over": "one launch at the paged serving shape, device time "
                   "(profiler); events_ms by CUDA events",
        "launches_per_step": k4["launches_per_step"],
        "shape": k4["shape"],
        "lengths": k4["lengths"],
        "paged_decode_step_ms": k4["decode_step_ms"],
        "paged_tokens_per_s": k4["tokens_per_s"],
        "profiled": k4["profiled"],
        "paged_runs": {k: paged[k] for k in "abc"},
    }, {
        "name": "count_transitions",
        "route": "cuda",
        "source": K5_SOURCE,
        "replaces": K5_REPLACES,
        "launches": quick_launches["transitions_cuda"],
        "launches_resnet50_sites": site_launches["transitions_cuda"],
        "launches_bench": bench["launches"]["transitions_cuda"],
        "max_abs_err": err5,
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
        **bound(k5),
        "library_ms": None,
        "ms_over": f"one launch on each of the {n_sites} ResNet50 weight "
                   f"streams at 224 px, device time (profiler), summed",
        "shapes": {"streams": n_sites, "words": sum(
            s[1].numel() for s in site_pass["sites"]), "dtype": "uint16"},
        "largest": k5["largest"],
    }, {
        "name": "bic_encode",
        "route": "cuda",
        "source": K6_SOURCE,
        "replaces": K6_REPLACES,
        "launches": quick_launches["bic_encode_cuda"],
        "launches_resnet50_sites": site_launches["bic_encode_cuda"],
        "launches_bench": bench["launches"]["bic_encode_cuda"],
        "max_abs_err": err6,
        "ms": k6["ms"],
        "plain_ms": k6["plain_ms"],
        **bound(k6),
        "library_ms": None,
        "ms_over": f"one launch on each of the {n_sites} ResNet50 weight "
                   f"streams at 224 px, device time (profiler), summed; "
                   f"plain_ms by CUDA events around each of the site "
                   f"pass's walks, summed",
        "shapes": {"streams": n_sites, "largest": k6["largest"],
                   "mask": "0x007f", "dtype": "uint16"},
    }, {
        "name": "zvg_matmul",
        "route": "cuda",
        "source": K7_SOURCE,
        "replaces": K7_REPLACES,
        "launches": quick_launches["zvg_matmul_cuda"],
        "launches_resnet50_sites": site_launches["zvg_matmul_cuda"],
        "launches_bench": bench["launches"]["zvg_matmul_cuda"],
        "max_abs_err": err7,
        "fault6_blocks": fault6["k7_blocks"],
        "max_rel_err": rel7,
        "rel_tol": {str(d).split(".")[-1]: v for d, v in TILED_TOL.items()},
        "resnet50_rel_err": site_pass["rel_err"],
        "ms": k7["ms"],
        "plain_ms": k7["plain_ms"],
        **bound(k7),
        "library_ms": k7["library_ms"],
        "library": k7["library"],
        "ms_over": f"one launch on each of the {n_sites} ResNet50 sites at "
                   f"224 px (bf16), CUDA events cycling through the sites, "
                   f"summed (plain_ms and library_ms the same way); "
                   f"profiler_ms the kernel's device time by the profiler",
        "profiler_ms": k7["profiler_ms"],
        "slowest_sites": k7["slowest"],
        "quickstart": k7["quickstart"],
        "gated_tiles": site_pass["gated_tiles"],
        "gated_by_site": site_pass["gated_by_site"],
        "tiles": site_pass["tiles"],
        "shapes": {"sites": n_sites, "dtype": "bfloat16",
                   "blocks": [128, 128, 128]},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
