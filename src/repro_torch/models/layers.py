"""Parameter inits and the common transformer layers.

Parameters are plain nested dicts of tensors (the JAX package's
``Param`` wrappers and logical axes have no counterpart: the port does
not shard). Inits draw from an explicit ``torch.Generator`` on its own
device; they need not reproduce ``jax.random`` -- weights that must
match the JAX package are carried across by :mod:`.convert`.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import matmul as mm


# ------------------------------------------------------------------ inits
def normal_init(shape, stddev: float, gen: torch.Generator) -> torch.Tensor:
    """float32 normal draws of ``shape`` scaled by ``stddev``, on the
    generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device) * stddev


def dense_param(d_in: int, d_out: int, gen: torch.Generator,
                stddev: float | None = None) -> torch.Tensor:
    """Fan-in-scaled dense kernel ``[d_in, d_out]``."""
    return normal_init((d_in, d_out),
                       d_in ** -0.5 if stddev is None else stddev, gen)


def bias_param(d: int, gen: torch.Generator) -> torch.Tensor:
    return torch.zeros(d, device=gen.device)


def scale_param(d: int, gen: torch.Generator) -> torch.Tensor:
    return torch.ones(d, device=gen.device)


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32, returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies ``[head_dim // 2]`` (float32)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the last dim of ``x [..., S, H, D]`` at
    integer ``positions [..., S]`` (broadcast over H), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs          # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                  # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- scalars
@functools.lru_cache(maxsize=None)
def weak(v: float, dtype: torch.dtype) -> float:
    """A Python scalar as the JAX package's weakly typed scalars enter an
    op on a ``dtype`` array: rounded to ``dtype`` first (bf16 0.22 is
    0.2197265625). PyTorch would use it unrounded in the op's float32
    compute type. Rounded on the host: no copy to the card."""
    return float(torch.tensor(v, dtype=dtype))


# -------------------------------------------------------------------- MLP
def silu(h: torch.Tensor) -> torch.Tensor:
    """``h * sigmoid(h)`` with the sigmoid as ``1 / (1 + exp(-h))``, each
    step rounded to ``h``'s dtype: the JAX package's SiLU as XLA runs it
    on the CPU (its logistic is expanded into those ops in the operand's
    type), bit for bit in bf16; ``F.silu`` rounds once, and parts from it
    in about 40% of bf16 words. The ``exp`` runs on float32: PyTorch's CPU
    bf16 ``exp`` has left later float32 ``exp`` calls of the process
    1.5e-4 off (at random). The quotient is a true division:
    ``torch.reciprocal`` (and ``1 / t``) may be approximate there."""
    e = torch.exp(-h.float()).to(h.dtype)
    return h * torch.div(e.new_ones(()), e + 1)


_ACTS = {"silu": silu, "gelu": lambda h: F.gelu(h, approximate="tanh"),
         "relu": F.relu}


def make_mlp(d: int, f: int, gen: torch.Generator,
             gated: bool = True) -> dict:
    p = {"up": dense_param(d, f, gen)}
    if gated:
        p["gate"] = dense_param(d, f, gen)
    p["down"] = dense_param(f, d, gen)
    return p


def apply_mlp(p: dict, x: torch.Tensor, act: str = "silu",
              backend: str | None = None) -> torch.Tensor:
    """``down(act(gate(x)) * up(x))`` (or ``down(act(up(x)))``
    ungated), every matmul through :func:`.matmul.matmul`."""
    actf = _ACTS[act]
    h = mm.matmul(x, p["up"], backend)
    if "gate" in p:
        h = actf(mm.matmul(x, p["gate"], backend)) * h
    else:
        h = actf(h)
    return mm.matmul(h, p["down"], backend)
