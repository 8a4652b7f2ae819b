"""AdamW with decoupled weight decay, global-norm clipping and optional
int8 gradient compression with error feedback, as the JAX package's
``repro.optim.adamw`` computes them (not ``torch.optim.AdamW``, whose
decay multiplies ``p`` before the step and which divides by
``sqrt(v) / sqrt(bc2)``).

The state mirrors the parameter tree: float32 ``m``, ``v`` (and ``err``
under compression) shaped like the params. All arithmetic is float32 in
the JAX package's order; ``t``, ``b1 ** t`` and the schedule are float32
tensors on the params' device, and every division whose quotient's bits
matter divides by a tensor (a CUDA tensor divided by a Python scalar is
multiplied by its reciprocal).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    m: dict
    v: dict
    err: dict | None        # error-feedback residual (compression only)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``lr`` is a float or a schedule ``fn(step) -> float32 tensor``."""
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress: bool = False   # int8 transport compression w/ error feedback

    def init(self, params) -> AdamWState:
        def zeros():
            return tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        return AdamWState(m=zeros(), v=zeros(),
                          err=zeros() if self.compress else None)

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, step):
        """``(updates, new_state)`` for an integer tensor ``step``; apply
        with ``params + updates``."""
        grads = tree_map(lambda g: g.float(), grads)
        if self.compress:
            grads, err = compress_with_feedback(grads, state.err)
        else:
            err = state.err
        if self.clip_norm > 0:
            gnorm = global_norm(grads)
            scale = torch.minimum(
                _f32(1.0, gnorm), _f32(self.clip_norm, gnorm)
                / torch.maximum(gnorm, _f32(1e-12, gnorm)))
            grads = tree_map(lambda g: g * scale, grads)

        t = step.float() + 1.0
        bc1 = 1.0 - _f32(self.b1, t) ** t
        bc2 = 1.0 - _f32(self.b2, t) ** t
        m = tree_map(lambda m_, g: self.b1 * m_ + (1 - self.b1) * g,
                     state.m, grads)
        v = tree_map(lambda v_, g: self.b2 * v_ + (1 - self.b2) * g * g,
                     state.v, grads)
        lr = self._lr(step)

        def upd(p, m_, v_):
            step_ = m_ / bc1 / (torch.sqrt(v_ / bc2) + self.eps)
            wd = self.weight_decay * p.float()
            return (-(lr * (step_ + wd))).to(p.dtype)

        updates = tree_map(upd, params, m, v)
        return updates, AdamWState(m=m, v=v, err=err)


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together, summed leaf by leaf in
    flattening order."""
    return torch.sqrt(sum(torch.sum(torch.square(x))
                          for x in tree_leaves(tree)))


def compress_with_feedback(grads, err):
    """Simulated transport compression: per-tensor int8 quantisation
    with error feedback (the residual carried to the next step). Returns
    ``(dequantised grads, new residuals)``."""
    def q(g, e):
        g = g + e
        scale = torch.clamp(g.abs().max(), min=1e-12) / _f32(127.0, g)
        qg = torch.clamp(torch.round(g / scale), -127, 127)
        deq = qg * scale
        return deq, g - deq

    out = [q(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warmup, then cosine decay to ``floor_frac * peak``: a
    function of an integer step tensor, float32 on its device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / _f32(max(warmup, 1), step)
        prog = torch.clamp((step - warmup) / _f32(max(total - warmup, 1),
                                                  step), 0.0, 1.0)
        cos = floor_frac * peak + (1 - floor_frac) * peak * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr
