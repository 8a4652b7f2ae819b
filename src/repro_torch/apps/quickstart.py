"""Quickstart: the paper's technique in a few lines, on the card.

Streams a ReLU-sparse activation matrix and a Gaussian weight matrix
through the modelled 16x16 output-stationary systolic array with the
paper's selective coding (BIC on weight mantissas, zero-value clock
gating on inputs) and prints the power outcome; then runs the stream
kernels on the same operands -- the BIC encoder and the transition
counter on the weight bus, the tile-gated matmul -- and prices the whole
named design menu from one pass. The counterpart of the JAX package's
``examples/quickstart.py``, line for line.

Run:  PYTHONPATH=src python -m repro_torch.apps.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import design
from repro_torch.apps import check_device
from repro_torch.core import power, systolic
from repro_torch.core.bits import to_bits
from repro_torch.kernels import bic_encode, count_transitions, zvg_matmul


def operands() -> tuple[np.ndarray, np.ndarray]:
    """The example's operands from ``default_rng(0)``: ReLU activations
    ``A [128, 512]`` (55% zeros) and near-zero weights ``W [512, 128]``,
    float32."""
    rng = np.random.default_rng(0)
    A = np.abs(rng.standard_normal((128, 512))).astype(np.float32)
    A[rng.random(A.shape) < 0.55] = 0.0
    W = (rng.standard_normal((512, 128)) * 0.05).astype(np.float32)
    return A, W


def run(device="cuda", backend: str | None = None) -> dict:
    """The example's computation on ``device``, every kernel through
    ``backend`` (``"auto"``: the Hopper kernels on the card, the plain
    versions on the CPU; ``"ref"``: the plain versions anywhere).

    Returns ``report`` and ``power`` (:func:`~repro_torch.core.systolic.
    sa_stream_report` and :func:`~repro_torch.core.power.sa_power`), the
    weight bus's toggles ``t_raw`` and ``t_enc`` (after mantissa BIC,
    invert line included), the gated matmul's ``out`` and ``gated`` map
    and its ``max_err`` against the float32 product, the design menu's
    ``evaluated`` energies and ``savings``, and the ``best`` design.
    """
    device = check_device(device, "the quickstart")
    A_np, W_np = operands()
    A = torch.from_numpy(A_np).to(device)
    W = torch.from_numpy(W_np).to(device)

    # 1) exact streaming-activity + power model (the paper's evaluation)
    report = systolic.sa_stream_report(A, W, backend=backend)
    pw = power.sa_power(report)

    # 2) the stream kernels: BIC on the weight bus, the gated matmul
    bits = to_bits(W.to(torch.bfloat16))
    tx, inv = bic_encode(bits, backend=backend)
    t_raw = int(count_transitions(bits, backend=backend).sum())
    t_enc = (int(count_transitions(tx, backend=backend).sum())
             + int((inv[1:] ^ inv[:-1]).sum()))
    out, gated = zvg_matmul(A.to(torch.bfloat16), W.to(torch.bfloat16),
                            backend=backend)
    max_err = float((out - systolic.sa_matmul_reference(A, W)).abs().max())

    # 3) design points: the whole named menu from ONE pass
    ev = design.evaluate_operands(A, W,
                                  tuple(design.named_designs().values()),
                                  backend=backend)
    best = min((n for n in ev if n != "baseline"),
               key=lambda n: float(ev[n]["energy"]["total"]))
    return {"report": report, "power": pw, "t_raw": t_raw, "t_enc": t_enc,
            "out": out, "gated": gated.cpu(), "max_err": max_err,
            "evaluated": ev, "savings": design.savings(ev), "best": best}


def lines(res: dict) -> list[str]:
    """The example's six lines of output for a :func:`run` result."""
    report, pw, sv, best = (res["report"], res["power"], res["savings"],
                            res["best"])
    t_raw, t_enc = res["t_raw"], res["t_enc"]
    return [
        f"input zero fraction        : {float(report['zero_fraction']):.2f}",
        f"streaming activity reduced : "
        f"{float(systolic.streaming_activity_reduction(report))*100:.1f}% "
        f"(paper avg: 29%)",
        f"total dynamic power saving : "
        f"{float(pw['saving_total'])*100:.1f}% (paper band: 1-19%)",
        f"weight-bus toggles         : {t_raw} -> {t_enc} "
        f"({(1-t_enc/t_raw)*100:.1f}% saved by mantissa BIC)",
        f"zero-gated matmul          : max err {res['max_err']:.3f}, "
        f"{int(res['gated'].sum())} tile(s) skipped entirely",
        f"design menu                : best={best} "
        f"({sv[best]['saving_total']*100:.1f}% vs "
        f"proposed {sv['proposed']['saving_total']*100:.1f}%)",
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.apps.quickstart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for line in lines(run(args.device)):
        print(line)


if __name__ == "__main__":
    main()
