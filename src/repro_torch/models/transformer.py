"""Block composition and the layer stack.

A block ``"attn+mlp"`` is pre-norm attention then a pre-norm MLP, each
added to the residual stream; ``"attn+moe"`` has a mixture of experts
(:mod:`.moe`) in the MLP's place, whose load-balancing loss the stack
sums over the layers. The stack is a loop over the layers in
execution order (``cfg.block_specs``); the JAX package's scanned groups
are unstacked by :mod:`.convert`, and the port has no remat.

Modes (one code path each, shared weights):
  prefill -- parallel over S, returns per-layer KV states padded to the
             cache length;
  decode  -- S = 1 with per-layer ``(k_cache, v_cache)`` states
             ``[B, cache_len, Hkv, D]``; row ``i`` writes its keys and
             values at ``positions[i, 0]``, which lets the serving engine
             co-batch requests sitting at different positions. The port
             writes the caches in place (the JAX package returns new
             arrays that XLA aliases to the donated ones).
  paged   -- ``pages [B, MP]`` given: the states are page pools ``[P,
             ps, Hkv, D]``; each row writes this step's keys and values
             into its pages through its table (in place), then attends
             through the table: S = 1 by the paged decode attention (K4
             on the card), a prefill chunk (S > 1) by the gather and
             :func:`.attention.paged_chunk_attention`.

Projection weights keep the names ``wq``/``wk``/``wv``/``wo``: the power
accountant's site names come from them. The model-wide tracer's names come
from :func:`repro_torch.trace.interpret.scope`, opened where the JAX
models open a ``named_scope`` (the block, its mixer and FFN, each
projection) and at each layer group of the stack (``scan[g]``, the JAX
package's scan iteration); with no trace running they do nothing.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.zvg_matmul import fused_paged_attention
from repro_torch.kernels.zvg_matmul.ref import gather_pages
from repro_torch.trace import interpret

from . import attention as A
from . import layers as L
from . import matmul as mm
from . import moe as M
from .config import ArchConfig


def parse_spec(spec: str) -> tuple[str, str]:
    mixer, _, ffn = spec.partition("+")
    return mixer, ffn or "none"


# ----------------------------------------------------------------- builders
def make_attention(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": L.dense_param(d, h * hd, gen),
         "wk": L.dense_param(d, kv * hd, gen),
         "wv": L.dense_param(d, kv * hd, gen),
         "wo": L.dense_param(h * hd, d, gen)}
    if cfg.qkv_bias:
        p["bq"] = L.bias_param(h * hd, gen)
        p["bk"] = L.bias_param(kv * hd, gen)
        p["bv"] = L.bias_param(kv * hd, gen)
    return p


def make_block(cfg: ArchConfig, spec: str, gen: torch.Generator) -> dict:
    ffn = parse_spec(spec)[1]
    return {"norm1": {"scale": L.scale_param(cfg.d_model, gen)},
            "mixer": make_attention(cfg, gen),
            "norm2": {"scale": L.scale_param(cfg.d_model, gen)},
            "ffn": (M.make_moe(cfg.d_model, cfg.moe, gen) if ffn == "moe"
                    else L.make_mlp(cfg.d_model, cfg.d_ff, gen,
                                    gated=cfg.mlp_gated))}


# ------------------------------------------------------------------ paging
def _page_targets(pages: torch.Tensor, positions: torch.Tensor,
                  page_size: int):
    """Physical ``(page, offset)`` write targets, each ``[B, S]``, of the
    logical ``positions [B, S]`` through the tables ``pages [B, MP]``.
    Negative positions (the right-padding mark of a chunk) and positions
    past the table go to the trash page 0, so one scatter serves live
    rows, dead rows (all-trash tables) and padded chunk tails."""
    mp = pages.shape[1]
    pos = positions.long()
    pg = torch.gather(pages.long(), 1,
                      torch.clamp(pos // page_size, 0, mp - 1))
    ok = (pos >= 0) & (pos < mp * page_size)
    return torch.where(ok, pg, 0), torch.clamp_min(pos, 0) % page_size


# --------------------------------------------------------------- attention
def apply_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                    positions: torch.Tensor, state=None,
                    prefill: bool = False, cache_len: int = 0,
                    pages: torch.Tensor | None = None,
                    backend: str | None = None):
    """Attention of one block. Returns ``(out, state)``: the decode
    state or the page pools updated in place, the prefill state padded to
    ``cache_len``, or ``None``."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = cfg.attn_scale or None

    def proj(w, bname, nh):
        with interpret.scope(w):
            y = mm.matmul(x, p[w], backend)
            if bname in p:
                y = y + p[bname]
        return y.reshape(b, s, nh, hd)

    def wo(out):
        with interpret.scope("wo"):
            return mm.matmul(out.reshape(b, s, h * hd), p["wo"], backend)

    q = proj("wq", "bq", h)
    k = proj("wk", "bk", kv)
    v = proj("wv", "bv", kv)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    if state is not None and pages is not None:   # ---- paged decode/chunk
        kp, vp = state                            # [P, ps, kv, hd] pools
        pg, off = _page_targets(pages, positions, kp.shape[1])
        kp[pg, off] = k.to(kp.dtype)
        vp[pg, off] = v.to(vp.dtype)
        if s == 1:
            # a chunk of one token runs the plain version, as prefill does
            out = fused_paged_attention(
                q.contiguous(), kp, vp, pages, positions[:, 0] + 1,
                A.decode_attention, scale=scale, softcap=cfg.attn_softcap,
                backend=backend or "ref")
        else:
            out = A.paged_chunk_attention(
                q, gather_pages(kp, pages), gather_pages(vp, pages),
                positions, scale=scale, softcap=cfg.attn_softcap)
        return wo(out), (kp, vp)

    if state is not None:                       # ---- single-token decode
        kc, vc = state
        bpos = positions[:, 0].long()
        rows = torch.arange(b, device=x.device)
        kc[rows, bpos] = k[:, 0].to(kc.dtype)
        vc[rows, bpos] = v[:, 0].to(vc.dtype)
        out = A.decode_attention(q, kc, vc, bpos + 1, scale=scale,
                                 softcap=cfg.attn_softcap)
        return wo(out), (kc, vc)

    out = A.chunked_attention(q, k, v, causal=True, scale=scale,
                              softcap=cfg.attn_softcap,
                              block_k=cfg.attn_block_k)
    out = wo(out)
    if not prefill:
        return out, None
    pad = (b, cache_len - s, kv, hd)
    return out, (torch.cat([k, k.new_zeros(pad)], dim=1),
                 torch.cat([v, v.new_zeros(pad)], dim=1))


# -------------------------------------------------------------------- block
def apply_block(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: str, *,
                positions: torch.Tensor, state=None, prefill: bool = False,
                cache_len: int = 0, pages: torch.Tensor | None = None,
                backend: str | None = None):
    """One block: ``(x, state, aux)``, ``aux`` the MoE's load-balancing
    loss (a float32 zero for a dense block)."""
    mixer, ffn = parse_spec(spec)
    aux = torch.zeros((), device=x.device)
    h = L.rms_norm(x, p["norm1"]["scale"])
    with interpret.scope(mixer):
        out, new_state = apply_attention(
            p["mixer"], h, cfg, positions=positions, state=state,
            prefill=prefill, cache_len=cache_len, pages=pages,
            backend=backend)
    x = x + L.weak(cfg.resid_mult, out.dtype) * out
    h = L.rms_norm(x, p["norm2"]["scale"])
    with interpret.scope(ffn):
        if ffn == "moe":
            y, aux = M.apply_moe(p["ffn"], h, cfg.moe, cfg.act, backend)
        else:
            y = L.apply_mlp(p["ffn"], h, cfg.act, backend)
    x = x + L.weak(cfg.resid_mult, y.dtype) * y
    return x, new_state, aux


# -------------------------------------------------------------------- stack
def apply_stack(layers: list, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, states: list | None = None,
                prefill: bool = False, cache_len: int = 0,
                pages: torch.Tensor | None = None,
                backend: str | None = None):
    """Run every layer. Returns ``(x, states, aux)``: the per-layer states
    for decode and paged steps (updated in place) and prefill, else
    ``None``; and the blocks' load-balancing losses summed in layer
    order, as the JAX package's stack sums them."""
    new_states = [] if (states is not None or prefill) else None
    aux_total = torch.zeros((), device=x.device)
    for i, (p, spec) in enumerate(zip(layers, cfg.block_specs)):
        with _layer_scope(cfg, i):
            x, st, aux = apply_block(
                p, x, cfg, spec, positions=positions,
                state=None if states is None else states[i],
                prefill=prefill, cache_len=cache_len, pages=pages,
                backend=backend)
        aux_total = aux_total + aux
        if new_states is not None:
            new_states.append(st)
    return x, new_states, aux_total


def _layer_scope(cfg: ArchConfig, i: int):
    """Layer ``i``'s naming frames, as the JAX stack names them: ``head<i>``
    and ``tail<i>`` for unrolled blocks, ``scan[g]/b<j>`` for block ``j`` of
    scanned group ``g`` (``b<j>`` alone when the groups are not scanned)."""
    if not interpret.active():
        return contextlib.nullcontext()
    n_head, n_pat = len(cfg.head), len(cfg.pattern)
    n_body = cfg.n_groups * n_pat
    if i < n_head:
        return interpret.scope(f"head{i}")
    if i >= n_head + n_body:
        return interpret.scope(f"tail{i - n_head - n_body}")
    g, j = divmod(i - n_head, n_pat)
    stack = contextlib.ExitStack()
    if cfg.scan_layers:
        stack.enter_context(interpret.scope(f"scan[{g}]"))
    stack.enter_context(interpret.scope(f"b{j}"))
    return stack
