#!/usr/bin/env python3
"""Time stream kernels of this tree against an earlier version of their
sources, in turns on one GPU, and sweep their plans at the main paths'
shapes: the counter pass (K1) and the BIC encoder (K6) against their
serial walks, the transition counter (K5) against its one-thread-a-lane
kernel.

Run from the repository root on a machine with an H100 and the CUDA
toolkit:

    python3 tools/walk_ab.py --old DIR [--kernels k5|k1,k6] [--sweep]
                             [--out FILE]

``DIR`` holds the earlier sources, for example unpacked with ``git
archive <rev> src/repro_torch/csrc | tar -x -C build/old``. For ``k5``
(the default) it holds a ``transitions.cu`` whose C entry takes no plan
and adds into a zeroed ``out`` (``tr_count_transitions(x, word_bytes,
init, T, L, mask, out, stream)``); the earlier wrapper's zero fill is
timed with it, as it ran. For ``k1,k6`` it holds a ``power_counters.cu``,
``power_counters.cuh`` and ``bic_encode.cu`` whose C entries take no
plan (the serial walks: ``pc_fused_counters(x, word_bytes, B, T, L,
counts, rowzeros, n_rows, ...)`` and ``be_bic_encode(x, word_bytes, T, L,
mask, tx, inv, stream)``). Both versions are built from source, held
bitwise equal on every stream, then timed old, new, new, old over the
main paths' launches. K5: over the 54 ResNet50 weight streams at 224 px
(device time by ``torch.profiler``; the largest alone also by CUDA
events) and at each shape ``chip_smoke.py`` logs (the stem, stage-1 3x3,
largest and fc weight streams, the quickstart's int32 words).  K1: over
ResNet50's 108 and MobileNetV1's 56 edge streams (profiler and CUDA
events) and at each shape ``chip_smoke.py`` logs; K6 over the 54 weight
streams (profiler; the largest alone by events). ``--sweep`` also times
every cluster size (K5) or chunk count (K1, K6) a stream can take at each
distinct shape of those paths (profiler), beside the plan's own. Every
line goes to standard output and to ``FILE`` (``build/walk_ab.txt`` by
default).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

_OUT = []


def say(msg: str) -> None:
    print(msg, flush=True)
    _OUT.append(msg)


def build_libs(src: Path, names) -> dict[str, ctypes.CDLL]:
    """Compile the earlier sources ``names`` (one ``nvcc`` each, all at
    once) and print their ptxas lines."""
    from repro_torch.kernels import _build

    out = ROOT / "build" / "walk_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
             str(lib), str(src / f"{name}.cu")],
            stdout=open(out / f"{name}.log", "w"), stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"old {name} failed to build: "
                               + (out / f"{name}.log").read_text()[-3000:])
        libs[name] = ctypes.CDLL(str(lib))
        for line in (out / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill stores" in line:
                say(f"old {name} ptxas: {line.strip()}")
    return libs


def build_old(src: Path) -> tuple:
    """The earlier K1 and K6 entries (the serial walks)."""
    libs = build_libs(src, ("power_counters", "bic_encode"))
    k1 = libs["power_counters"].pc_fused_counters
    k1.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    k6 = libs["bic_encode"].be_bic_encode
    k6.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    return k1, k6


def old_transitions(fn, x: torch.Tensor, mask: int = 0xFFFF):
    """The earlier K5 through its own C entry, as its wrapper called it:
    a zero fill, then the kernel adding into it."""
    T, L = x.shape
    out = torch.zeros(L, dtype=torch.int32, device=x.device)
    err = fn(x.data_ptr(), x.element_size(), None, T, L, mask,
             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old K5 failed: CUDA error {err}")
    return out


def old_counters(fn, x: torch.Tensor, spec):
    """The earlier K1 through its own C entry, as its wrapper called it."""
    from repro_torch.kernels.power_counters.kernel import spec_args

    x3 = x if x.dim() == 3 else x[None]
    B, T, L = x3.shape
    counts = torch.empty((B, spec.n_rows, L), dtype=torch.int32,
                         device=x.device)
    rowzeros = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    err = fn(x3.data_ptr(), x.element_size(), B, T, L, counts.data_ptr(),
             rowzeros.data_ptr(), spec.n_rows, *spec_args(spec),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old K1 failed: CUDA error {err}")
    return (counts, rowzeros) if x.dim() == 3 else (counts[0], rowzeros[0])


def old_encode(fn, x: torch.Tensor, mask: int):
    T, L = x.shape
    tx = torch.empty_like(x)
    inv = torch.empty((T, L), dtype=torch.bool, device=x.device)
    err = fn(x.data_ptr(), x.element_size(), T, L, mask, tx.data_ptr(),
             inv.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old K6 failed: CUDA error {err}")
    return tx, inv


def net_streams(net: str):
    """The main path's edge streams of ``net`` at 224 px: per site (name,
    west words, west spec, north words, north spec)."""
    from repro_torch import design as D
    from repro_torch.apps.cnn import nets
    from repro_torch.kernels.power_counters import CounterSpec

    designs = tuple(D.named_designs().values())
    ((geom, precision), kw), = D.menu_args(designs).items()
    wspec = CounterSpec(bic_variants=kw["west_bic"], zvg=kw["west_zvg"])
    nspec = CounterSpec(bic_variants=kw["north_bic"], zvg=kw["north_zvg"])
    images = nets.synthetic_images(1, 224, seed=7, device="cuda")
    out = []
    for t in nets.forward_with_traces(net, images, seed=0):
        a, b = cs.site_streams(t, geom, precision)
        out.append((t.name, a, wspec, b, nspec))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--kernels", default="k5", choices=("k5", "k1,k6"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "walk_ab.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("walk_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.deterministic = True
    say(f"card: {cs.card_line()}")
    (run_k5 if args.kernels == "k5" else run_k1_k6)(args)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("\n".join(_OUT) + "\n")
    return 0


def k5_streams():
    """K5's main-path streams: the 54 ResNet50 weight streams (uint16)
    and the quickstart's weight words (int32 ``[512, 128]``), and the
    logged ones by label."""
    from repro_torch.apps import quickstart
    from repro_torch.core.bits import to_bits

    weights = [(name, cs.site_words(W)) for name, W in _weights()]
    W = torch.from_numpy(quickstart.operands()[1]).cuda()
    quick = to_bits(W.to(torch.bfloat16)).contiguous()
    by_shape = {tuple(w.shape): (name, w) for name, w in weights}
    logged = [(f"{by_shape[s][0]} {s}", by_shape[s][1])
              for s in cs.K5_PLAN_SHAPES] + [("quickstart", quick)]
    return weights, logged


def run_k5(args) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.transitions import kernel as k5
    from repro_torch.kernels.transitions.ref import transitions_ref

    _build.build_all(("transitions",))
    fn = build_libs(args.old, ("transitions",))["transitions"] \
        .tr_count_transitions
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_void_p, ctypes.c_void_p]
    weights, logged = k5_streams()
    for name, w in weights + logged:
        got, old = k5.transitions_cuda(w), old_transitions(fn, w)
        want = transitions_ref(w.to(torch.int32))
        if not (torch.equal(got, want) and torch.equal(old, want)):
            raise AssertionError(f"K5 {name}: new, old and plain differ")
    say(f"new == old == plain, bitwise: K5 on {len(weights)} weight "
        f"streams and {len(logged)} logged shapes")
    fns = {"new": lambda w: k5.transitions_cuda(w),
           "old": lambda w: old_transitions(fn, w)}
    big = max(weights, key=lambda s: s[1].numel())[1]
    for turn in ("old", "new", "new", "old"):
        f = fns[turn]
        ws = [lambda w=w: f(w) for _, w in weights]
        say(f"{turn} K5 {len(ws)} weight streams: device "
            f"{len(ws) * cs.device_ms(ws):.4f} ms; largest "
            f"{tuple(big.shape)} by events "
            f"{cs.time_ms(lambda: f(big), 20):.5f} ms, by the profiler "
            f"{cs.device_ms([lambda: f(big)] * 5):.5f} ms")
        for label, w in logged:
            plan = k5.transitions_plan(*w.shape, w.element_size())
            say(f"{turn} K5 {label} {tuple(w.shape)} {w.dtype}: device "
                f"{cs.device_ms([lambda w=w: f(w)] * 5):.5f} ms (plan "
                f"width {plan.tx}, cluster {plan.cluster}, cycles "
                f"{plan.cycles})")
    if args.sweep:
        seen = {}
        for name, w in weights + logged:
            seen.setdefault((tuple(w.shape), w.dtype), (name, w))
        for (shape, dt), (name, w) in seen.items():
            T, L = shape
            wb = w.element_size()
            plan = k5.transitions_plan(T, L, wb)
            row = []
            for tx in k5._route(L, wb, True)[2]:
                for cl in (1, 2, 4, 8, 16):
                    p = k5.split_transitions(T, L, wb, cl, tx=tx)
                    ms = cs.device_ms([lambda p=p: k5.transitions_cuda(
                        w, plan=p)] * 3)
                    row.append(f"{tx}/{cl}x{p.cycles}:{ms * 1e3:.2f}")
            say(f"sweep K5 {name} T{T} L{L} {dt} plan {plan.tx}/"
                f"{plan.cluster}x{plan.cycles}: " + " ".join(row)
                + " (tile width / cluster x cycles: us)")


def run_k1_k6(args) -> None:
    from repro_torch.core.bits import MANT_MASK
    from repro_torch.kernels import _build
    from repro_torch.kernels.bic_encode import kernel as k6
    from repro_torch.kernels.power_counters import kernel as k1

    torch.backends.cudnn.deterministic = True
    say(f"card: {cs.card_line()}")
    _build.build_all(("power_counters", "bic_encode"))
    old1, old6 = build_old(args.old)

    sites = {net: net_streams(net) for net in ("resnet50", "mobilenet")}
    launches = {net: [(f"{name} {edge}", x, spec)
                      for name, a, ws, b, ns in ss
                      for edge, x, spec in (("west", a, ws), ("north", b, ns))]
                for net, ss in sites.items()}
    weights = [(name, cs.site_words(W)) for name, W in _weights()]
    # both versions bitwise equal on every stream
    for net, ls in launches.items():
        for name, x, spec in ls:
            got, want = k1.fused_counters_cuda(x, spec), old_counters(
                old1, x, spec)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K1 {net} {name}: new != old")
    for name, w in weights:
        if not all(torch.equal(g, o) for g, o in zip(
                k6.bic_encode_cuda(w, MANT_MASK),
                old_encode(old6, w, MANT_MASK))):
            raise AssertionError(f"K6 {name}: new != old")
    say(f"new == old, bitwise: K1 on {sum(map(len, launches.values()))} "
        f"streams, K6 on {len(weights)}")

    k1_fns = {
        "new": lambda x, s: k1.fused_counters_cuda(x, s),
        "old": lambda x, s: old_counters(old1, x, s)}
    k6_fns = {"new": lambda w: k6.bic_encode_cuda(w, MANT_MASK),
              "old": lambda w: old_encode(old6, w, MANT_MASK)}
    shapes = cs.k1_shapes(sites["resnet50"], sites["mobilenet"])
    for turn in ("old", "new", "new", "old"):
        for net, ls in launches.items():
            fns = [lambda x=x, s=s, f=k1_fns[turn]: f(x, s)
                   for _, x, s in ls]
            dev = len(fns) * cs.device_ms(fns)
            ev = len(fns) * cs.time_cycle(fns, 3)
            say(f"{turn} K1 {net} {len(fns)} launches: device {dev:.4f} ms, "
                f"events {ev:.4f} ms")
        for label, x, s in shapes:
            f = k1_fns[turn]
            say(f"{turn} K1 {label} {tuple(x.shape)}: device "
                f"{cs.device_ms([lambda: f(x, s)] * 5):.5f} ms")
        fns = [lambda w=w, f=k6_fns[turn]: f(w) for _, w in weights]
        big = max(weights, key=lambda s: s[1].shape[0])[1]
        say(f"{turn} K6 {len(fns)} weight streams: device "
            f"{len(fns) * cs.device_ms(fns):.4f} ms; largest "
            f"{tuple(big.shape)} by events "
            f"{cs.time_ms(lambda: k6_fns[turn](big), 5):.5f} ms")
    if args.sweep:
        sweep(launches, weights, shapes)




def _weights():
    from repro_torch.apps.cnn import analysis, nets

    images = nets.synthetic_images(1, 224, seed=7, device="cuda")
    for t in nets.forward_with_traces("resnet50", images, seed=0):
        yield t.name, analysis.matmul_operands(t)[1]


def sweep(launches, weights, shapes) -> None:
    """Every chunk count at each distinct K1 and K6 shape (profiler)."""
    from repro_torch.core.bits import MANT_MASK
    from repro_torch.kernels.bic_encode import kernel as k6
    from repro_torch.kernels.power_counters import kernel as k1

    seen = {}
    for ls in launches.values():
        for name, x, s in ls:
            seen.setdefault((tuple(x.shape), s.n_rows), (name, x, s))
    for label, x, s in shapes[-2:]:
        seen.setdefault((tuple(x.shape), s.n_rows), (label, x, s))
    for (shape, n_rows), (name, x, s) in seen.items():
        B, T, L = (1, *shape) if len(shape) == 2 else shape
        plan = k1.counter_plan(B, T, L)
        row = []
        for n in (1, 2, 4, 8, 16, 32, 64, 128):
            if n > 1 and -(-T // n) < 4:
                break
            p = k1.split_plan(B, T, L, n)
            ms = cs.device_ms([lambda: k1.fused_counters_cuda(x, s, p)] * 3)
            row.append(f"{n}:{ms * 1e3:.1f}")
        say(f"sweep K1 {name} B{B} T{T} L{L} rows{n_rows} plan "
            f"{plan.chunks}: " + " ".join(row) + " (us)")
    done = set()
    for name, w in weights:
        T, L = w.shape
        if (T, L) in done:
            continue
        done.add((T, L))
        row = []
        for n in (1, 2, 4, 8, 16, 32, 64, 128):
            if n > 1 and -(-T // n) < 4:
                break
            p = k1.split_plan(1, T, L, n)
            ms = cs.device_ms([lambda: k6.bic_encode_cuda(
                w, MANT_MASK, p)] * 3)
            row.append(f"{n}:{ms * 1e3:.1f}")
        say(f"sweep K6 {name} T{T} L{L} plan {k6.bic_plan(T, L).chunks}: "
            + " ".join(row) + " (us)")


if __name__ == "__main__":
    sys.exit(main())
