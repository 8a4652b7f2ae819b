"""Mixture-of-Experts with capacity-based top-k routing (the port's copy
of the JAX package's ``repro.models.moe``).

Tokens are grouped (a group is a sequence chunk) and each group dispatches
into per-expert capacity buffers through one-hot einsums: the dispatch,
the gated expert MLP and the combine are the JAX package's five einsums,
in the input dtype, each through :func:`repro_torch.trace.interpret.
einsum` (the tracer's seam; plain ``torch.einsum`` with no trace
running). The router runs in float32 on the float32 master.

Tokens dropped by capacity overflow give all-zero rows in the dispatched
expert inputs: the zero streams the paper's zero-value gating exploits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.trace import interpret

from . import attention as A
from . import layers as L
from . import matmul as mm


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 2
    expert_ff: int = 1408
    num_shared: int = 0             # shared (always-on) experts
    shared_ff: int = 0              # ff width of the shared expert block
    capacity_factor: float = 1.25
    group_size: int = 512           # tokens per dispatch group
    router_noise: float = 0.0


def make_moe(d: int, cfg: MoEConfig, gen: torch.Generator) -> dict:
    """Random float32 masters from ``gen``: the router ``[D, E]``, the
    experts' ``w_gate``/``w_up`` ``[E, D, F]`` and ``w_down`` ``[E, F, D]``,
    and a shared MLP when the config has shared experts."""
    e, f = cfg.num_experts, cfg.expert_ff
    p = {"router": L.dense_param(d, e, gen),
         "w_gate": L.normal_init((e, d, f), d ** -0.5, gen),
         "w_up": L.normal_init((e, d, f), d ** -0.5, gen),
         "w_down": L.normal_init((e, f, d), f ** -0.5, gen)}
    if cfg.num_shared:
        p["shared"] = L.make_mlp(d, cfg.shared_ff
                                 or cfg.expert_ff * cfg.num_shared, gen)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the ``k`` largest values and
    their indices, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_dispatch(logits: torch.Tensor, k: int, capacity: int):
    """Dispatch and combine tensors of top-k capacity routing.

    Args:
      logits: float32 ``[G, S, E]`` router logits per group.
    Returns:
      dispatch ``[G, S, E, C]`` one-hot, combine ``[G, S, E, C]`` weighted,
      and the Switch-style load-balancing loss (a 0-d float32 tensor).
    """
    g, s, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    # aux loss: mean router probability x mean top-1 assignment per expert
    top1 = torch.argmax(logits, dim=-1)
    me = torch.nn.functional.one_hot(top1, e).to(logits.dtype).mean((0, 1))
    ce = probs.mean((0, 1))
    aux = e * (me * ce).sum()

    gates, experts = _top_k(probs, k)                     # [G, S, k]
    slots = torch.arange(capacity, device=logits.device)
    dispatch = logits.new_zeros((g, s, e, capacity))
    combine = logits.new_zeros((g, s, e, capacity))
    # occupancy per expert, carried across the k selections
    occupancy = torch.zeros((g, e), dtype=torch.int32, device=logits.device)
    for i in range(k):
        sel = torch.nn.functional.one_hot(experts[:, :, i], e).to(
            logits.dtype)                                  # [G, S, E]
        pos = (occupancy[:, None, :] + torch.cumsum(sel, dim=1)
               - sel).to(torch.int32)
        keep = (pos < capacity) * sel
        occupancy = occupancy + keep.sum(dim=1).to(torch.int32)
        # positions past the capacity one-hot to all-zero rows, as
        # jax.nn.one_hot does
        oh_pos = (pos[..., None] == slots).to(logits.dtype)
        d_i = keep[..., None] * oh_pos                     # [G, S, E, C]
        dispatch = dispatch + d_i
        combine = combine + d_i * gates[:, :, i][..., None, None]
    return dispatch, combine, aux


def _ep_constrain(t: torch.Tensor, expert_dim: int) -> torch.Tensor:
    """Pin expert-parallel buffers ``[g, e, c, d]`` to (groups over the
    data axes, experts over the model axis) on a mesh, as the JAX
    package's ``_ep_constrain`` does; a plain tensor passes as it is."""
    spec = [None] * t.ndim
    spec[0] = "dp"
    spec[expert_dim] = "model"
    return A._try_constrain(t, tuple(spec))


def apply_moe(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str = "silu",
              backend: str | None = None):
    """MoE layer: ``x [B, S, D] -> (y [B, S, D], aux)``. ``p`` holds the
    router as its float32 master and the experts (and a shared MLP) in
    ``x``'s dtype; ``backend`` reaches the shared MLP's matmuls only (the
    JAX package's einsums never take the gated kernel). On a mesh the
    expert buffers are pinned to the expert-parallel layout
    (:func:`_ep_constrain`)."""
    b, s, d = x.shape
    gs = min(cfg.group_size, s)
    if s % gs:
        raise ValueError(f"sequence {s} is not a multiple of the group "
                         f"size {gs}")
    xg = x.reshape(b * (s // gs), gs, d)
    logits = mm.matmul(xg.float(), p["router"])
    capacity = max(int(gs * cfg.top_k * cfg.capacity_factor
                       / cfg.num_experts), 1)
    dispatch, combine, aux = _topk_dispatch(logits, cfg.top_k, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)

    xin = _ep_constrain(interpret.einsum("gsec,gsd->gecd", dispatch, xg),
                        1)
    actf = L._ACTS[act]
    h = (actf(interpret.einsum("gecd,edf->gecf", xin, p["w_gate"]))
         * interpret.einsum("gecd,edf->gecf", xin, p["w_up"]))
    y = _ep_constrain(interpret.einsum("gecf,efd->gecd", h, p["w_down"]),
                      1)
    out = interpret.einsum("gsec,gecd->gsd", combine, y).reshape(b, s, d)
    if "shared" in p:
        out = out + L.apply_mlp(p["shared"], x, act, backend)
    return out, aux
