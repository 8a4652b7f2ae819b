"""Parameter inits and the common transformer layers.

Parameters are plain nested dicts of tensors; their logical axes (the
JAX package's ``Param.axes``) are a tree of their own,
:func:`repro_torch.models.lm.param_axes`, which the sharding rules of
:mod:`repro_torch.runtime.sharding` resolve on a mesh (where the leaves
become DTensors). Inits draw from an explicit ``torch.Generator`` on its own
device; they need not reproduce ``jax.random`` -- weights that must
match the JAX package are carried across by :mod:`.convert`.
"""
from __future__ import annotations

import functools
import math

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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in float32, returned in ``x``'s dtype. The
    variance is the population variance (``jnp.var``), not torch's
    default ``n - 1`` divisor."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def make_norm(kind: str, d: int, gen: torch.Generator) -> dict:
    """``{"scale"}`` for RMS norm, ``{"scale", "bias"}`` for LayerNorm."""
    p = {"scale": scale_param(d, gen)}
    if kind != "rms":
        p["bias"] = bias_param(d, gen)
    return p


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies ``[head_dim // 2]`` (float32)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    """YaRN's attention temperature factor ``0.1 mscale ln(scale) + 1``
    (1 for ``scale <= 1``)."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(beta_fast: float, beta_slow: float, dim: int,
                          base: float, max_pos: int) -> tuple[int, int]:
    """The rotary dims ``(low, high)`` between which YaRN ramps from the
    original to the interpolated frequencies: the dims that turn
    ``beta_fast`` and ``beta_slow`` times over ``max_pos`` positions,
    floored and ceiled, within ``[0, dim - 1]``."""
    def dim_of(rot):
        return (dim * math.log(max_pos / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    return (max(math.floor(dim_of(beta_fast)), 0),
            min(math.ceil(dim_of(beta_slow)), dim - 1))


def yarn_inv_freq(head_dim: int, theta: float, scaling,
                  device=None) -> torch.Tensor:
    """YaRN's inverse frequencies ``[head_dim // 2]`` (float32) for a
    :class:`repro_torch.models.config.RopeScaling`, in the published
    float32 operations (``DeepseekV2YarnRotaryEmbedding``): ``freq_extra``
    (the plain frequencies) below the correction range, ``freq_inter``
    (over ``factor``) above it, blended by the linear ramp between."""
    pows = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                  device=device) / head_dim)
    freq_extra = 1.0 / pows
    freq_inter = 1.0 / (scaling.factor * pows)
    low, high = yarn_correction_range(
        scaling.beta_fast, scaling.beta_slow, head_dim, theta,
        scaling.original_max_position_embeddings)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, scaling=None) -> torch.Tensor:
    """Rotary embedding over the last dim of ``x [..., S, H, D]`` at
    integer ``positions [..., S]`` (broadcast over H), in float32.
    ``scaling`` (a :class:`repro_torch.models.config.RopeScaling`, or
    None for plain RoPE) takes YaRN's frequencies and scales cos and sin
    by its ``mscale`` ratio."""
    if scaling is None:
        freqs = rope_freqs(x.shape[-1], theta, x.device)
    else:
        freqs = yarn_inv_freq(x.shape[-1], theta, scaling, x.device)
    ang = positions[..., None].float() * freqs          # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                  # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    if scaling is not None:
        m = (yarn_get_mscale(scaling.factor, scaling.mscale)
             / yarn_get_mscale(scaling.factor, scaling.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections,
                theta: float = 1e6) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL) over ``x [B, S, H, D]``: the ``D / 2``
    frequency bands split into ``sections`` (temporal, height, width),
    each rotated by its own stream of ``positions [3, B, S]``."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum "
                         f"to {d // 2}")
    freqs = rope_freqs(d, theta, x.device)
    ang_per = positions[..., None].float() * freqs      # [3, B, S, D/2]
    sel = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))        # [D/2]
    ang = torch.gather(ang_per.movedim(0, -1), -1,
                       sel.expand(ang_per.shape[1:3] + sel.shape)[..., None]
                       )[..., 0]                        # [B, S, D/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings ``[..., d]`` (float32; MusicGen), ``sin``
    on the first half of the bands and ``cos`` on the second."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------- scalars
@functools.lru_cache(maxsize=None)
def weak(v: float, dtype: torch.dtype) -> float:
    """A Python scalar as the JAX package's weakly typed scalars enter an
    op on a ``dtype`` array: rounded to ``dtype`` first (bf16 0.22 is
    0.2197265625). PyTorch would use it unrounded in the op's float32
    compute type. Rounded on the host: no copy to the card."""
    return float(torch.tensor(v, dtype=dtype))


# -------------------------------------------------------------------- MLP
#: the smallest normal float32 (and bfloat16) magnitude
_TINY = torch.finfo(torch.float32).tiny


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) with subnormal values flushed to a zero of their
    sign, as XLA's CPU code runs with denormals flushed (inputs and
    results)."""
    return torch.where(t.abs() < _TINY, t * 0, t)


def sigmoid(h: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-h))``, each step rounded to ``h``'s dtype: the JAX
    package's ``jax.nn.sigmoid`` as XLA expands its logistic on the CPU,
    with subnormals flushed as XLA flushes them -- bit for bit in bf16
    over every bf16 word (``torch.sigmoid`` rounds once and parts from it
    in about a third of bf16 words; fault 9). The ``exp`` runs on float32
    (PyTorch's CPU bf16 ``exp`` has left later float32 ``exp`` calls of
    the process 1.5e-4 off, at random), and the quotient is a true
    division (``torch.reciprocal`` and ``1 / t`` may be approximate)."""
    e = _ftz(torch.exp(-_ftz(h.float()))).to(h.dtype)
    return _ftz(torch.div(e.new_ones(()), e + 1).float()).to(h.dtype)


def silu(h: torch.Tensor) -> torch.Tensor:
    """``h * sigmoid(h)``, each step rounded to ``h``'s dtype and
    subnormals flushed (:func:`sigmoid`): the JAX package's SiLU as XLA
    runs it on the CPU, bit for bit in bf16; ``F.silu`` rounds once, and
    parts from it in about 40% of bf16 words (fault 8)."""
    return _ftz((_ftz(h.float()) * sigmoid(h).float())).to(h.dtype)


def gelu(h: torch.Tensor) -> torch.Tensor:
    """The tanh GELU of ``jax.nn.gelu``, ``h * 0.5 * (1 + tanh(sqrt(2 /
    pi) * (h + 0.044715 * h ** 3)))``, each step rounded to ``h``'s dtype
    and subnormals flushed, as XLA runs it on the CPU: bit for bit in
    bf16 over every bf16 word (``F.gelu(approximate="tanh")`` rounds once
    and parts from it in about 43% of bf16 words; fault 9). The constants
    enter as the JAX package's do, rounded to ``h``'s dtype."""
    dt = h.dtype

    def r(t):                  # one float32 step, rounded to h's dtype
        return _ftz(_ftz(t).to(dt).float())

    x = r(h.float())
    cube = r(r(x * x) * x)
    inner = r(x + r(weak(0.044715, dt) * cube))
    t = r(torch.tanh(r(weak(math.sqrt(2 / math.pi), dt) * inner)))
    cdf = r(weak(0.5, dt) * r(weak(1.0, dt) + t))
    return r(x * cdf).to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` in its form: ``max(x, 0)
    + log1p(exp(-|x|))``. In float32 the two frameworks' ``exp`` and
    ``log1p`` round apart by an ulp in some 9-15% of values, so callers
    hold the results at a tolerance, not bitwise."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


_ACTS = {"silu": silu, "gelu": gelu, "relu": F.relu}


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
