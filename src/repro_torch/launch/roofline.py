"""Roofline analysis over the port's dry-run cache (``results/dryrun_torch/``,
written by :mod:`repro_torch.launch.dryrun`).

Per (arch x shape) cell on a mesh, derive the three terms per rank:

  compute term    = dot_FLOPs_per_rank / PEAK_FLOPS
  memory term     = mem_bytes_per_rank / HBM_BW
  collective term = collective_bytes_per_rank / NVLINK_BW

All three come from :mod:`repro_torch.launch.graph_analysis`'s per-rank
counts of one step. The bottleneck is the max term; the MFU bound is
MODEL_FLOPS-based:

  mfu_bound = (MODEL_FLOPS / ranks / PEAK_FLOPS) / max(terms)

and the useful-compute ratio MODEL_FLOPS / counted FLOPs quantifies
masked-attention and dispatch overhead.

Hardware constants: NVIDIA H100 SXM5 80GB (NVIDIA's datasheet; dense
rates at the 700 W limit) -- 989 TFLOP/s bf16 Tensor Core without
sparsity, 3.35 TB/s HBM3, 900 GB/s NVLink (fourth generation, per GPU),
80 GB of HBM. A card set below 700 W runs slower under load.
"""
from __future__ import annotations

import glob
import json
import os

#: the card the constants are for
SKU = "NVIDIA H100 SXM5 80GB"
PEAK_FLOPS = 989e12        # bf16 dense Tensor Core, FLOP/s
HBM_BW = 3.35e12           # HBM3, bytes/s
NVLINK_BW = 900e9          # NVLink 4, bytes/s per GPU
HBM_BYTES = 80e9           # device memory

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def load_cells(pod: str = "pod1", results_dir: str | None = None
               ) -> list[dict]:
    cells = []
    root = os.path.abspath(results_dir or RESULTS_DIR)
    for p in sorted(glob.glob(os.path.join(root, f"*__{pod}.json"))):
        with open(p) as f:
            cells.append(json.load(f))
    return cells


def terms(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    g = rec["graph"]
    ranks = rec["n_ranks"]
    t_comp = g["dot_flops_per_rank"] / PEAK_FLOPS
    t_mem = g.get("mem_bytes_per_rank", 0.0) / HBM_BW
    t_coll = g["collective_bytes_per_rank"] / NVLINK_BW
    t_max = max(t_comp, t_mem, t_coll, 1e-12)
    model_total = rec["model_flops"]["total"]
    t_model = model_total / ranks / PEAK_FLOPS
    counted_global = g["dot_flops_per_rank"] * ranks
    bottleneck = {t_comp: "compute", t_mem: "memory",
                  t_coll: "collective"}[t_max]
    return {
        "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
        "bottleneck": bottleneck,
        "mfu_bound": t_model / t_max,
        "useful_ratio": model_total / max(counted_global, 1.0),
        "model_flops": model_total,
        "counted_flops_global": counted_global,
        "peak_gib": rec["memory"]["peak_bytes_per_rank"] / 2**30,
        "fits": rec["memory"]["peak_bytes_per_rank"] <= HBM_BYTES,
    }


SUGGESTIONS = {
    "collective": ("shrink TP/SP re-sharding traffic (fuse norm into "
                   "attention shards, widen per-rank model dim, or trade "
                   "model-axis for extra FSDP on small models)"),
    "memory": ("cut HBM traffic: fused kernels over the eager op chain, "
               "bf16 cache/optimizer layouts, or a quantized KV cache "
               "for decode"),
    "compute": ("near roofline -- remove masked-attention overhead "
                "(a flash kernel halves score FLOPs) and raise the "
                "useful-compute ratio"),
}


def table(pod: str = "pod1", results_dir: str | None = None) -> list[str]:
    rows = []
    head = (f"| {'arch':24s} | {'shape':11s} | {'comp s':>9s} | "
            f"{'mem s':>9s} | {'coll s':>9s} | {'bound':10s} | "
            f"{'MFU bound':>9s} | {'useful':>6s} | {'GiB/rank':>8s} |")
    rows.append(head)
    rows.append("|" + "-" * (len(head) - 2) + "|")
    for rec in load_cells(pod, results_dir):
        t = terms(rec)
        if t is None:
            reason = rec.get("reason", rec.get("error", ""))[:40]
            rows.append(f"| {rec['arch']:24s} | {rec['shape']:11s} | "
                        f"{'--':>9s} | {'--':>9s} | {'--':>9s} | "
                        f"{rec['status']:10s} | {'':>9s} | {'':>6s} | "
                        f"{'':>8s} | {reason}")
            continue
        rows.append(
            f"| {rec['arch']:24s} | {rec['shape']:11s} | "
            f"{t['compute_s']:9.4f} | {t['memory_s']:9.4f} | "
            f"{t['collective_s']:9.4f} | {t['bottleneck']:10s} | "
            f"{t['mfu_bound']:9.3f} | {t['useful_ratio']:6.2f} | "
            f"{t['peak_gib']:8.2f} |")
    return rows


def print_summary(pod: str = "pod1", results_dir: str | None = None) -> None:
    print(f"# roofline against {SKU}: {PEAK_FLOPS / 1e12:g} TFLOP/s bf16, "
          f"HBM {HBM_BW / 1e12:g} TB/s, NVLink {NVLINK_BW / 1e9:g} GB/s")
    for r in table(pod, results_dir):
        print(r)
    cells = [(rec, terms(rec)) for rec in load_cells(pod, results_dir)]
    ok = [(r, t) for r, t in cells if t]
    if not ok:
        return
    worst = min(ok, key=lambda x: x[1]["mfu_bound"])
    coll = max(ok, key=lambda x: x[1]["collective_s"]
               / max(x[1]["compute_s"], 1e-12))
    print(f"# worst MFU bound: {worst[0]['arch']}/{worst[0]['shape']} "
          f"({worst[1]['mfu_bound']:.3f})")
    print(f"# most collective-bound: {coll[0]['arch']}/{coll[0]['shape']}")


def cell_report(arch: str, shape: str, pod: str = "pod1",
                results_dir: str | None = None) -> str:
    path = os.path.join(os.path.abspath(results_dir or RESULTS_DIR),
                        f"{arch}__{shape}__{pod}.json")
    with open(path) as f:
        rec = json.load(f)
    t = terms(rec)
    if t is None:
        return f"{arch}/{shape}: {rec['status']}"
    return (f"{arch}/{shape} [{rec['mesh']}]: "
            f"compute {t['compute_s']*1e3:.2f} ms, "
            f"memory {t['memory_s']*1e3:.2f} ms, "
            f"collective {t['collective_s']*1e3:.2f} ms -> "
            f"{t['bottleneck']}-bound; MFU bound {t['mfu_bound']:.3f}; "
            f"useful ratio {t['useful_ratio']:.2f}; "
            f"{t['peak_gib']:.2f} GiB a rank of "
            f"{HBM_BYTES / 2**30:.1f}. "
            f"Next: {SUGGESTIONS[t['bottleneck']]}")


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--pod", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--results", default=None,
                    help="dry-run cache (default results/dryrun_torch)")
    args = ap.parse_args(argv)
    print_summary(args.pod, args.results)


if __name__ == "__main__":
    main()
