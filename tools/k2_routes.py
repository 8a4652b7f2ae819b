"""K2's two routes on the card, at MiniCPM3-4B's decode products.

First holds the wide route (bfloat16 on the tensor cores) to its rule
(``chip_smoke.wide_route_cases``). Then times a whole decode
step of K2's products (62 layers of seven distinct weights and the head,
7.6 GB of bfloat16 weights, each read once, as a step reads them) by CUDA
events, each launch by ctypes (eager) and the step replayed as a CUDA
graph (device time alone): the stream route, the wide route,
``torch.matmul`` and the plain version, at 1 to 128 rows; each product's
device time at 128 rows, with the wide route's other column tiles; and
the host's time a call of each route through the wrapper. Writes a JSON file and prints a table. Run from the
repository root on a GPU machine:

    python tools/k2_routes.py [--out chiprun_out/k2_routes.json] \
        [--skip-check]
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.zvg_matmul import kernel, ref  # noqa: E402

ROWS = (1, 2, 4, 8, 16, 32, 64, 128)
LAYERS = 62
#: one layer's products in the order a decode step runs them, then the head
LAYER = ((2560, 768), (2560, 256), (2560, 32), (2560, 2560), (2560, 6400),
         (2560, 6400), (6400, 2560))
HEAD = (2560, 73448)
REPS = 5


def events(fn, reps=REPS) -> list[float]:
    """Milliseconds of ``fn()`` by CUDA events, ``reps`` times after one
    warm run."""
    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def host_parts(dev, n=3000) -> dict:
    """The host's microseconds a call of each part of the wrapper's work,
    at 128 rows of the 2560 x 768 product."""
    from repro_torch.kernels.zvg_matmul import ref as zref

    x = torch.randn(128, 2560, device=dev).to(torch.bfloat16)
    w = torch.randn(2560, 768, device=dev).to(torch.bfloat16)
    out = torch.empty(128, 768, dtype=torch.bfloat16, device=dev)
    _, _, wide = kernel._functions()
    p = kernel.wide_plan(128, 2560, 768)
    st = kernel._stream(x.device)
    parts = {
        "wrapper": lambda: kernel.gated_row_matmul_cuda(x, w),
        "check_operands": lambda: zref.check_operands(x, w,
                                                      zref.GEMM_DTYPES),
        "check_on_card": lambda: kernel._check_on_card("k2", x, w),
        "empty": lambda: torch.empty((128, 768), dtype=torch.bfloat16,
                                     device=x.device),
        "wide_route": lambda: kernel.wide_route(x, w),
        "wide_plan": lambda: kernel.wide_plan(128, 2560, 768),
        "stream_handle": lambda: kernel._stream(x.device),
        "ctypes_launch": lambda: wide(x.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), 128, 2560, 768,
                                      p.tile_m, p.tile_n, p.k_per_split,
                                      p.workers, 0, st),
    }
    got = {}
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        got[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    print("host us a call by part: " + ", ".join(
        f"{k} {v:.2f}" for k, v in got.items()), flush=True)
    return got


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/k2_routes.json")
    ap.add_argument("--skip-check", action="store_true",
                    help="time only (the wide cases were held already)")
    ap.add_argument("--sweep", action="store_true",
                    help="also every column tile and split at 128 rows")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    res = {"card": card}
    if not args.skip_check:
        res["check_max_abs_diff"] = cs.wide_route_cases()

    gemm, _, wide = kernel._functions()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def weight(K, N):
        return (torch.randn(K, N, generator=gen, device=dev)
                * K ** -0.5).to(torch.bfloat16)

    layers = [[weight(K, N) for K, N in LAYER] for _ in range(LAYERS)]
    head = weight(*HEAD)
    step = [w for lay in layers for w in lay] + [head]
    nbytes = sum(w.numel() * 2 for w in step)
    print(f"{len(step)} products a step, {nbytes / 1e9:.3f} GB of weights",
          flush=True)

    def runner(M, route, ws=step, plans=None):
        """A function that runs the products of ``ws`` at ``M`` rows on
        ``route`` on the current stream (so a CUDA graph can take it)."""
        xs = {K: torch.randn(M, K, generator=gen, device=dev)
              .to(torch.bfloat16) for K in {w.shape[0] for w in ws}}
        outs = {(w.shape): torch.empty(M, w.shape[1], dtype=torch.bfloat16,
                                       device=dev) for w in ws}
        calls = []
        for w in ws:
            K, N = w.shape
            x, o = xs[K], outs[(K, N)]
            if route == "stream":
                kps = kernel.decode_plan(K, N, 2).k_per_split
                calls.append((gemm, (x.data_ptr(), 1, w.data_ptr(), 1,
                                     o.data_ptr(), 1, M, K, N, kps)))
            elif route == "wide":
                p = (plans or {}).get((K, N))
                if p is None:
                    q = kernel.wide_plan(M, K, N)
                    p = q.tile_m, q.tile_n, q.k_per_split, q.workers
                calls.append((wide, (x.data_ptr(), w.data_ptr(),
                                     o.data_ptr(), M, K, N, *p, 0)))
            elif route == "matmul":
                calls.append((torch.matmul, (x, w)))
            else:
                calls.append((ref.gated_row_matmul_ref, (x, w)))

        def run():
            st = torch.cuda.current_stream().cuda_stream
            for fn, a in calls:
                if route in ("stream", "wide"):
                    err = fn(*a, st)
                    if err:
                        raise RuntimeError(f"{route} launch failed at {M} "
                                           f"rows: CUDA error {err}")
                else:
                    fn(*a)
        run.operands = xs, outs   # the launches hold their pointers only
        return run

    def graphed(run):
        """``run`` captured in a CUDA graph: its replay, device time alone
        (no host dispatch between the launches)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        return g.replay

    steps, graphs = {}, {}
    for M in ROWS:
        for route in ("wide", "stream", "matmul") + (
                ("plain",) if M in (8, 32, 128) else ()):
            run = runner(M, route)
            t = events(run)
            g = events(graphed(run))
            steps[f"{route}@{M}"], graphs[f"{route}@{M}"] = t, g
            print(f"step M={M:4d} {route:7s} eager {statistics.median(t):9.4f}"
                  f" ms, graph {statistics.median(g):9.4f} ms "
                  f"({min(g):.4f}-{max(g):.4f})", flush=True)
    res["step_ms_eager"], res["step_ms_graph"] = steps, graphs
    res["bound_ms_128"] = sum(2.0 * (128 * w.shape[0] + w.numel()
                                     + 128 * w.shape[1])
                              for w in step) / 3.35e12 * 1e3

    per = {}
    for K, N in dict.fromkeys(LAYER + (HEAD,)):
        ws = ([lay[LAYER.index((K, N))] for lay in layers]
              if (K, N) != HEAD else [head] * 8)
        n = len(ws)
        row = {}
        for route in ("stream", "wide", "matmul"):
            row[route] = statistics.median(events(graphed(
                runner(128, route, ws))))
        row = {k: v / n * 1e3 for k, v in row.items()}   # us a launch
        row["plan"] = kernel.wide_plan(128, K, N).__dict__
        per[f"{K}x{N}"] = row
        print(f"M=128 {K}x{N} (graph): " + ", ".join(
            f"{k} {v:.2f} us" for k, v in row.items() if k != "plan"),
            flush=True)
    res["per_product_us_128"] = per

    if args.sweep:   # every column tile and split at 128 rows
        sweep = {}
        for K, N in dict.fromkeys(LAYER + (HEAD,)):
            ws = ([lay[LAYER.index((K, N))] for lay in layers]
                  if (K, N) != HEAD else [head] * 8)
            stages = -(-K // kernel.WIDE_STAGE)
            for tn in (64, 128):
                tiles = -(-N // tn)
                for want in (1, 2, 4, 8, 16):
                    per = -(-stages // want)
                    splits = -(-stages // per)
                    plan = (128, tn, per * kernel.WIDE_STAGE,
                            min(tiles, kernel.SMS) if splits == 1 else tiles)
                    us = statistics.median(events(graphed(runner(
                        128, "wide", ws, {(K, N): plan})))) / len(ws) * 1e3
                    sweep[f"{K}x{N} n{tn} s{splits}"] = us
                    print(f"sweep {K}x{N} tile_n {tn} splits {splits} "
                          f"({plan[3] * splits} blocks): {us:.2f} us",
                          flush=True)
        res["sweep_us_128"] = sweep

    host = {}
    x = torch.randn(128, 2560, device=dev).to(torch.bfloat16)
    x6 = torch.randn(128, 6400, device=dev).to(torch.bfloat16)
    saved = kernel.WIDE_MIN_ROWS
    for route, rows in (("stream", 1 << 30), ("wide", 1),
                        ("wide", 1), ("stream", 1 << 30)) * 3:
        kernel.WIDE_MIN_ROWS = rows
        for w in step[:20]:
            kernel.gated_row_matmul_cuda(x6 if w.shape[0] == 6400 else x, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in step:
            kernel.gated_row_matmul_cuda(x6 if w.shape[0] == 6400 else x, w)
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        host.setdefault(route, []).append(dt / len(step) * 1e6)
    kernel.WIDE_MIN_ROWS = saved
    res["host_us_a_call"] = host
    res["host_parts_us"] = host_parts(dev)
    print(f"host us a call (128 rows, a step's 435 calls, stream and wide "
          f"in turns): {json.dumps(host)}; medians stream "
          f"{statistics.median(host['stream']):.2f}, wide "
          f"{statistics.median(host['wide']):.2f}", flush=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
