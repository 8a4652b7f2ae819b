"""Mixture-of-Experts: capacity-based top-k routing (the port's copy of
the JAX package's ``repro.models.moe``), and the dropless route that
serving a published MoE needs (``MoEConfig.dropless``, the port's own;
:func:`apply_moe_dropless`).

Tokens are grouped (a group is a sequence chunk) and each group dispatches
into per-expert capacity buffers through one-hot einsums: the dispatch,
the gated expert MLP and the combine are the JAX package's five einsums,
in the input dtype, each through :func:`repro_torch.trace.interpret.
einsum` (the tracer's seam; plain ``torch.einsum`` with no trace
running). The router runs in float32 on the float32 master.

Tokens dropped by capacity overflow give all-zero rows in the dispatched
expert inputs: the zero streams the paper's zero-value gating exploits.
Capacity is set per call, so a prompt loses expert outputs wherever an
expert overflows its group, and a chunk drops other tokens than a whole
prompt does: the capacity route stays for training and for parity with
the JAX package.

The dropless route gives each token its own top-k experts whatever shares
its call: the float32 softmax router (its product in fixed row tiles, so
a row's logits do not depend on its batch mates), greedy top-k in the
capacity route's stable tie order, the (token, expert) pairs sorted by
expert with each expert's row offsets, the gated expert MLP over each
expert's contiguous rows (K8, :mod:`repro_torch.kernels.expert_matmul`:
one launch for gate and up with SiLU in its epilogue, one for down), the
outputs weighted by the unnormalised gate and summed per token in float32
in top-k order, rounded once, and the shared experts added as the capacity
route adds them. Its spans: ``moe.route``, ``moe.experts`` and
``moe.combine``.

The routed products take ``expert_backend``, which a step builder sets
apart from ``backend`` where the two differ: serving's prefill keeps its
projections plain (``backend`` None) and runs its experts on K8, since
the plain route is a loop over experts and row tiles. ``None`` follows
``backend``, and a ``backend`` of None is the plain route
(:mod:`repro_torch.models.matmul`), which autograd differentiates; K8
has no backward and refuses to run where autograd records.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.expert_matmul import expert_matmul
from repro_torch.runtime import spans
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
    # route without capacity (module doc): capacity_factor and group_size
    # do not apply. The port's own; off, as in the JAX package
    dropless: bool = False


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
              backend: str | None = None,
              expert_backend: str | None = None):
    """MoE layer: ``x [B, S, D] -> (y [B, S, D], aux)``. ``p`` holds the
    router as its float32 master and the experts (and a shared MLP) in
    ``x``'s dtype; ``backend`` reaches the shared MLP's matmuls only (the
    JAX package's einsums never take the gated kernel), and
    ``expert_backend`` the dropless route's routed products (module doc).
    On a mesh the expert buffers are pinned to the expert-parallel layout
    (:func:`_ep_constrain`)."""
    if cfg.dropless:
        return apply_moe_dropless(p, x, cfg, act, backend, expert_backend)
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


#: rows of the router's product tiles (see :func:`_row_product`)
ROUTER_TILE = 16


def _row_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [T, K] @ w [K, N]`` in tiles of :data:`ROUTER_TILE` rows, zero
    rows padding the last: one batched product whose row count per tile is
    fixed, so a row's result does not depend on how many rows share the
    call (PyTorch's CPU matmul picks its kernel by the row count)."""
    t = x.shape[0]
    pad = (-t) % ROUTER_TILE
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    out = torch.matmul(x.view(-1, ROUTER_TILE, x.shape[1]), w)
    return out.reshape(-1, w.shape[1])[:t]


def apply_moe_dropless(p: dict, x: torch.Tensor, cfg: MoEConfig,
                       act: str = "silu", backend: str | None = None,
                       expert_backend: str | None = None):
    """The dropless MoE layer (module doc): ``x [B, S, D] -> (y [B, S,
    D], aux)``. The routed products take ``expert_backend`` (None:
    ``backend``), K8 on the card with ``"auto"`` or ``"cuda"``, the plain
    per-expert route with ``"ref"`` or None; the shared experts' matmuls
    take ``backend`` as the capacity route's do. ``aux``, the Switch-style
    load-balancing loss over the call's tokens, is computed only where
    autograd records (training): a float32 zero under ``no_grad``."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.num_experts
    t = b * s
    xt = x.reshape(t, d)
    with spans.span("moe.route"):
        logits = _row_product(xt.float(), p["router"])         # [T, E]
        probs = torch.softmax(logits, dim=-1)
        gates, experts = _top_k(probs, k)                      # [T, k]
        flat = experts.reshape(-1)
        # pairs in expert order, token order within an expert
        order = torch.sort(flat, stable=True).indices
        # a scatter, not torch.bincount: on the card that reads the
        # largest index back to the host, a sync every layer
        counts = flat.new_zeros(e).scatter_add_(0, flat,
                                                torch.ones_like(flat))
        offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]
                            ).to(torch.int32)
        xs = xt.index_select(0, torch.div(order, k, rounding_mode="floor"))
    with spans.span("moe.experts"):
        be = expert_backend or backend or "ref"
        h = expert_matmul(xs, p["w_gate"], offsets, t, w_up=p["w_up"],
                          act=L._ACTS[act], silu=act == "silu", backend=be)
        ys = expert_matmul(h, p["w_down"], offsets, t, backend=be)
    with spans.span("moe.combine"):
        y = torch.empty_like(ys).index_copy_(0, order, ys).float()
        y = y.view(t, k, d)
        out = y[:, 0] * gates[:, :1]
        for j in range(1, k):
            out.addcmul_(y[:, j], gates[:, j:j + 1])
        out = out.to(x.dtype).reshape(b, s, d)
    if "shared" in p:
        out = out + L.apply_mlp(p["shared"], x, act, backend)
    aux = logits.new_zeros(())
    if torch.is_grad_enabled():
        top1 = experts[:, 0]
        me = (top1.new_zeros(e).scatter_add_(0, top1, torch.ones_like(top1))
              .to(logits.dtype) / t)
        aux = e * (me * probs.mean(0)).sum()
    return out, aux
