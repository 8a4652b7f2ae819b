"""RG-LRU recurrent block (Griffin / RecurrentGemma) and its temporal
convolution (the port's copy of the JAX package's
``repro.models.recurrent``).

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)                      (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                      (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)            (0 < a_t < 1)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence as the JAX package's
``jax.lax.associative_scan`` does: the same tree of float32 affine-map
combines (:func:`associative_scan`), so its sums round as the JAX
package's do. Decode is the single step with the carried state. The
matmuls are plain products through :func:`repro_torch.models.matmul.
matmul` with no backend -- the JAX package's bare ``@``, which the
tracer sees and the gated kernel never runs. ``Lambda`` stays a float32
master; the gates' ``softplus`` and ``exp`` run in float32 and part from
the JAX package's by an ulp in some values, so the states are held at a
tolerance, not bitwise.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.trace import interpret

from . import layers as L
from . import matmul as mm

_C = 8.0  # Griffin's fixed scaling constant


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0           # 0 => model width
    conv_width: int = 4
    window: int = 2048           # sliding window of the companion attention


def make_conv1d(d: int, width: int, gen: torch.Generator) -> dict:
    return {"w": L.normal_init((width, d), d ** -0.5, gen),
            "b": L.bias_param(d, gen)}


def apply_conv1d(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise temporal conv over ``x [B, S, D]``: the taps
    summed in order, each a product in ``x``'s dtype (the JAX package's
    ``sum(pad[:, i:i + S] * w[i])``)."""
    w = p["w"]
    width, s = w.shape[0], x.shape[1]
    pad = torch.cat([x.new_zeros((x.shape[0], width - 1, x.shape[2])), x],
                    dim=1)
    out = 0
    for i in range(width):
        out = out + pad[:, i:i + s] * w[i]
    return out + p["b"]


def conv1d_decode(p: dict, buf: torch.Tensor, x_t: torch.Tensor):
    """Single-step conv: ``buf [B, W-1, D]`` holds the previous inputs.
    Returns ``(out [B, D], buf)``."""
    window = torch.cat([buf, x_t[:, None]], dim=1)       # [B, W, D]
    out = interpret.einsum("bwd,wd->bd", window, p["w"]) + p["b"]
    return out, window[:, 1:]


def conv_tail(x: torch.Tensor, cw: int) -> torch.Tensor:
    """The last ``cw - 1`` steps of ``x [B, S, D]``, left-padded with
    zeros when ``S < cw - 1``: a conv buffer after a prefill."""
    pad = max(cw - 1 - x.shape[1], 0)
    if pad:
        x = torch.cat([x.new_zeros((x.shape[0], pad, x.shape[2])), x], 1)
    return x[:, -(cw - 1):]


def make_rglru(d: int, gen: torch.Generator) -> dict:
    # Lambda such that a^c lies in [0.9, 0.999] (Griffin's appendix)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, d, device=gen.device)) / _C))
    return {"w_a": L.dense_param(d, d, gen, stddev=d ** -0.5),
            "b_a": L.bias_param(d, gen),
            "w_x": L.dense_param(d, d, gen, stddev=d ** -0.5),
            "b_x": L.bias_param(d, gen),
            "lambda": lam}


def _gates(p: dict, x: torch.Tensor):
    """The float32 affine maps ``(a, b)`` of the recurrence,
    ``h -> a * h + b``, for ``x [B, S, D]``."""
    r = L.sigmoid(mm.matmul(x, p["w_a"]) + p["b_a"])
    i = L.sigmoid(mm.matmul(x, p["w_x"]) + p["b_x"])
    log_a = -_C * L.softplus(p["lambda"]) * r.float()
    a = torch.exp(log_a)
    gated_x = (i * x).float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                   1e-12)) * gated_x
    return a, b


def associative_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """Inclusive scan of the affine maps ``(a, b)`` along ``dim`` under
    ``(a1, b1) then (a2, b2) = (a2 * a1, a2 * b1 + b2)``, combined in the
    tree ``jax.lax.associative_scan`` uses (adjacent pairs, recurse on
    the odd elements, fill in the even ones), so the float32 sums round
    as the JAX package's do. ``O(log S)`` rounds of elementwise ops."""
    a, b = _scan0(a.movedim(dim, 0), b.movedim(dim, 0))
    return a.movedim(0, dim), b.movedim(0, dim)


def _combine(left, right):
    return right[0] * left[0], right[0] * left[1] + right[1]


def _scan0(a: torch.Tensor, b: torch.Tensor):
    n = a.shape[0]
    if n < 2:
        return a, b
    odd = _scan0(*_combine((a[0:n - 1:2], b[0:n - 1:2]), (a[1::2], b[1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:-1], odd[1][:-1]), (a[2::2], b[2::2]))
    else:
        even = _combine(odd, (a[2::2], b[2::2]))
    out = []
    for first, e, o in zip((a, b), even, odd):
        t = first.new_empty(first.shape)
        t[0] = first[0]
        t[2::2] = e
        t[1::2] = o
        out.append(t)
    return tuple(out)


def apply_rglru(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None):
    """Parallel RG-LRU over ``x [B, S, D]``: ``(y [B, S, D] in x's dtype,
    the float32 last state [B, D])``."""
    a, b = _gates(p, x)
    if h0 is not None:
        # fold the carried state into the first step: h1 = a1*h0 + b1
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    _, h = associative_scan(a, b, dim=1)
    return h.to(x.dtype), h[:, -1]


def rglru_decode(p: dict, h: torch.Tensor, x_t: torch.Tensor):
    """One decode step: ``h [B, D]`` float32 state, ``x_t [B, D]``."""
    a, b = _gates(p, x_t[:, None])
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x_t.dtype), h_new


def make_recurrent_block(d: int, cfg: RGLRUConfig,
                         gen: torch.Generator) -> dict:
    """Griffin's recurrent block: in-projections (x, gate), conv1d,
    RG-LRU, gated out-projection."""
    w = cfg.lru_width or d
    return {"in_x": L.dense_param(d, w, gen),
            "in_gate": L.dense_param(d, w, gen),
            "conv": make_conv1d(w, cfg.conv_width, gen),
            "rglru": make_rglru(w, gen),
            "out": L.dense_param(w, d, gen)}


def apply_recurrent_block(p: dict, x: torch.Tensor, state=None,
                          want_state: bool = False):
    """``x [B, S, D]``; ``state`` is ``None`` (prefill) or ``(conv_buf,
    h)`` (a decode step, S = 1). With ``want_state`` a prefill also
    returns the decode state: the conv input's tail and the last
    recurrence state."""
    gate = L.gelu(mm.matmul(x, p["in_gate"]))
    u = mm.matmul(x, p["in_x"])
    if state is None:
        y, h_last = apply_rglru(p["rglru"], apply_conv1d(p["conv"], u))
        out = mm.matmul(y * gate, p["out"])
        if not want_state:
            return out, None
        return out, (conv_tail(u, p["conv"]["w"].shape[0]), h_last)
    conv_buf, h = state
    u_t, conv_buf = conv1d_decode(p["conv"], conv_buf, u[:, 0])
    y_t, h = rglru_decode(p["rglru"], h, u_t)
    return mm.matmul(y_t[:, None] * gate, p["out"]), (conv_buf, h)

