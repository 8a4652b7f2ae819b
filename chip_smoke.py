#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds every CUDA source of the port, holds each kernel bitwise
against its plain PyTorch version on the card, drives the main path --
the paper's CNN power measurement, ``analyze_network("resnet50")`` at
224 px with the whole design menu, then ``select_network`` -- counting
the kernel's launches in that run, checks every site's counters against
the plain version, runs MobileNetV1 at 224 px through the batched
depthwise form the same way, and times the kernel at the main path's
shapes. The line before the last lists the kernels as JSON; the last line
is ``{"ok": true, "device": {...}}``. Without a card, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the float32
#: non-tensor rate, which bounds integer ALU work from above
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

KERNEL_SOURCE = "src/repro_torch/csrc/power_counters.cu"
KERNEL_REPLACES = "src/repro/kernels/power_counters/kernel.py:335"


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
    for B, T, L in ((5, 257, 33), (64, 9, 3136), (3, 4609, 20)):
        x = adversarial_words(T, L, gen, batch=B)
        err = max(err, assert_kernel_matches(x, full, f"batch {B}x{T}x{L}"))
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


# ---------------------------------------------------------------- timing
def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_timing(sites) -> dict:
    from repro_torch.kernels.power_counters.kernel import fused_counters_cuda
    from repro_torch.kernels.power_counters.ref import fused_counters_ref

    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    shapes = []
    for name, a_bits, wspec, b_bits, nspec in sites:
        for edge, x, spec in (("west", a_bits, wspec),
                              ("north", b_bits, nspec)):
            ms = time_ms(lambda: fused_counters_cuda(x, spec), 10)
            plain = time_ms(lambda: fused_counters_ref(x, spec), 3)
            b_ms, o_ms = launch_cost(x, spec)
            tot["ms"] += ms
            tot["plain_ms"] += plain
            tot["bytes_ms"] += b_ms
            tot["ops_ms"] += o_ms
            if name in ("stem", "s4b1.c2"):
                shapes.append({
                    "site": name, "edge": edge, "T": x.shape[-2],
                    "L": x.shape[-1], "n_rows": spec.n_rows, "ms": ms,
                    "plain_ms": plain, "bound_ms": max(b_ms, o_ms)})
    tot["shapes"] = shapes
    return tot


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch import design as D
    from repro_torch.kernels import _build

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

    err = phase_kernel_cases()
    designs = tuple(D.named_designs().values())
    layers, launches, _ = run_main_path("resnet50", designs, 54)
    sites, e = check_sites("resnet50", layers, designs)
    err = max(err, e)
    mlayers, mlaunches, _ = run_main_path("mobilenet", designs, 28)
    _, e = check_sites("mobilenet", mlayers, designs)
    err = max(err, e)

    phase_breakdown("resnet50", designs)
    tot = phase_timing(sites)
    bound_ms = max(tot["bytes_ms"], tot["ops_ms"])
    log(f"power_counters over the ResNet50 main path's {launches} launch "
        f"shapes: kernel {tot['ms']:.3f} ms, plain version "
        f"{tot['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms")
    log(json.dumps({"kernels": [{
        "name": "power_counters",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "launches_mobilenet": mlaunches,
        "max_abs_err": err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                     else "operations"),
        "library_ms": None,
        "ms_over": "sum over the ResNet50 main path's launch shapes",
        "shapes": tot["shapes"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
