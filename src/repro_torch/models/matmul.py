"""Decode-path matmul dispatch.

Every projection, MLP and lm-head matmul of the model goes through
:func:`matmul`. Its ``backend`` comes down from the step builder that
runs it, never from module state:

* ``None`` -- plain ``x @ w``: prefill and every other parallel-over-S
  path, as the JAX package leaves them to XLA;
* ``"auto"`` -- the ZVG-gated row matmul (K2): its Hopper kernel for CUDA
  tensors, its plain version for CPU tensors (the decode default);
* ``"cuda"`` -- the kernel; raises for tensors that are not on the card;
* ``"ref"`` -- the plain version on any device, which the card-side
  differential runs.

Weights that are not 2-D take the plain path, as in the JAX package.
Under the model-wide tracer (:mod:`repro_torch.trace.interpret`) it is a
seam: it emits its site itself, whichever route runs the product.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.power_counters.ops import BACKENDS
from repro_torch.kernels.zvg_matmul import gated_row_matmul
from repro_torch.runtime import spmd
from repro_torch.trace import interpret



def check_backend(backend: str | None) -> None:
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; expected "
                         f"one of {BACKENDS}")


def matmul(x: torch.Tensor, w: torch.Tensor,
           backend: str | None = None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` through ``backend`` (see module doc)."""
    if interpret.active():
        if w.dim() == 2:
            interpret.emit_matmul(x, w)
        with interpret.seam():
            return _matmul(x, w, backend)
    return _matmul(x, w, backend)


def _matmul(x: torch.Tensor, w: torch.Tensor, backend: str | None):
    if spmd.is_dist(x) or spmd.is_dist(w):
        return spmd.matmul(lambda a, b: _plain(a, b, backend), x, w)
    return _plain(x, w, backend)


def _plain(x: torch.Tensor, w: torch.Tensor, backend: str | None):
    if backend is None or w.dim() != 2:
        return x @ w
    out = gated_row_matmul(x.reshape(-1, x.shape[-1]), w, backend)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))
