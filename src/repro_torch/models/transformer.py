"""Block composition and the layer stack.

A block spec ``"<mixer>[+<ffn>]"`` composes a sequence mixer with a
feed-forward in pre-norm residual form (RMS norm or LayerNorm, as the
config says). Mixers: grouped-query attention (``attn``), its
sliding-window form over a ring cache (``local``), Multi-head Latent
Attention over a latent cache (``mla``), the RG-LRU recurrent block
(``rglru``, :mod:`.recurrent`) and the xLSTM blocks (``mlstm``,
``slstm``, :mod:`.xlstm`). FFNs: a dense MLP, a mixture of experts
(:mod:`.moe`, whose load-balancing loss the stack sums over the layers),
or none. The stack is a loop over the layers in execution order
(``cfg.block_specs``); the JAX package's scanned groups are unstacked by
:mod:`.convert`, and the port has no remat.

Modes (one code path each, shared weights):
  prefill -- parallel over S, returns each layer's decode state: KV
             states padded to the cache length, the latent cache, the
             ring of the last ``window`` positions (``-1`` marks a slot
             never written), the recurrent and xLSTM states with their
             conv buffers;
  decode  -- S = 1 with per-layer states (:func:`repro_torch.models.lm.
             make_decode_state`); row ``i`` writes at ``positions[i, 0]``,
             which lets the serving engine co-batch requests sitting at
             different positions. The port updates every state in place
             (the JAX package returns new arrays that XLA aliases to the
             donated ones).
  paged   -- ``pages [B, MP]`` given (``attn`` and ``mla``): the states
             are page pools, ``[P, ps, Hkv, D]`` (``attn``) or the latent
             pools ``ckv [P, ps, r]`` and ``kr [P, ps, dr]`` (``mla``);
             each row writes this step's entries into its pages through
             its table (in place), then attends through the table. For
             ``attn``, S = 1 by the paged decode attention (K4 on the
             card), a prefill chunk (S > 1) by the gather and
             :func:`.attention.paged_chunk_attention`; ``mla`` gathers its
             pages and runs the absorbed decode under a per-query causal
             mask, for S = 1 and chunks alike, as the JAX package does
             (K4 is ``attn``'s alone).

Which products go through the gated matmul (K2 in decode) follows the
JAX package exactly: the projections it runs through ``models.matmul``
(attention's ``wq``/``wk``/``wv``/``wo``; MLA's ``w_dq``, ``w_dkv``,
``w_kr`` and decode ``wo``; the MLPs; the head) take ``backend``; its
bare ``@`` and einsums (the recurrent and xLSTM blocks, MLA's per-head
products) never do. Projection weights keep the JAX package's names: the
power accountant's site names come from them. The model-wide tracer's
names come from :func:`repro_torch.trace.interpret.scope`, opened where
the JAX models open a ``named_scope`` (the block, its mixer and FFN, each
attention projection) and at each layer group of the stack (``scan[g]``,
the JAX package's scan iteration); with no trace running they do
nothing. Each block's norms, mixer and FFN are also host spans
(:mod:`repro_torch.runtime.spans`: ``model.norm``, ``model.<mixer>``,
``model.<ffn>``; inside a dropless ``model.moe``, ``moe.route``,
``moe.experts`` and ``moe.combine``), free unless switched on or profiled.
MLA scales its softmax by :func:`mla_scale` and its RoPE by the config's
``rope_scaling`` (YaRN) on all three paths.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.kernels.zvg_matmul import fused_paged_attention
from repro_torch.kernels.zvg_matmul.ref import gather_pages
from repro_torch.runtime import spans
from repro_torch.runtime import spmd as S
from repro_torch.trace import interpret

from . import attention as A
from . import layers as L
from . import matmul as mm
from . import moe as M
from . import recurrent as R
from . import xlstm as X
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


def make_mla(cfg: ArchConfig, gen: torch.Generator) -> dict:
    mla = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = (mla.qk_nope_head_dim, mla.qk_rope_head_dim,
                  mla.v_head_dim)
    r = mla.kv_lora_rank
    p = {"w_dkv": L.dense_param(d, r, gen),
         "kv_norm": L.make_norm("rms", r, gen),
         "w_kr": L.dense_param(d, dr, gen),
         "w_uk": L.normal_init((r, h, dn), r ** -0.5, gen),
         "w_uv": L.normal_init((r, h, dv), r ** -0.5, gen),
         "wo": L.dense_param(h * dv, d, gen)}
    if mla.q_lora_rank:
        rq = mla.q_lora_rank
        p["w_dq"] = L.dense_param(d, rq, gen)
        p["q_norm"] = L.make_norm("rms", rq, gen)
        p["w_uq"] = L.normal_init((rq, h, dn + dr), rq ** -0.5, gen)
    else:
        p["wq"] = L.normal_init((d, h, dn + dr), d ** -0.5, gen)
    return p


def make_mixer(cfg: ArchConfig, mixer: str, gen: torch.Generator) -> dict:
    if mixer in ("attn", "local"):
        return make_attention(cfg, gen)
    if mixer == "mla":
        return make_mla(cfg, gen)
    if mixer == "rglru":
        return R.make_recurrent_block(cfg.d_model, cfg.rglru, gen)
    if mixer == "mlstm":
        return X.make_mlstm(cfg.d_model, cfg.xlstm, gen)
    if mixer == "slstm":
        return X.make_slstm(cfg.d_model, cfg.xlstm, gen)
    raise ValueError(mixer)


def make_block(cfg: ArchConfig, spec: str, gen: torch.Generator) -> dict:
    mixer, ffn = parse_spec(spec)
    p = {"norm1": L.make_norm(cfg.norm, cfg.d_model, gen),
         "mixer": make_mixer(cfg, mixer, gen)}
    if ffn != "none":
        p["norm2"] = L.make_norm(cfg.norm, cfg.d_model, gen)
        p["ffn"] = (M.make_moe(cfg.d_model, cfg.moe, gen) if ffn == "moe"
                    else L.make_mlp(cfg.d_model, cfg.d_ff, gen,
                                    gated=cfg.mlp_gated))
    return p


# ------------------------------------------------------------------ helpers
def _decode_batch_pos(cfg: ArchConfig, positions: torch.Tensor):
    """Each row's cache-write index of a decode step, ``[B]``: rows may
    sit at different positions (continuous batching)."""
    p = positions[0] if cfg.pos == "mrope" else positions
    return p[:, 0].long()


def _rope_qk(cfg: ArchConfig, q, k, positions):
    if cfg.pos == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    elif cfg.pos == "mrope":
        q = L.apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = L.apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    return q, k


def _write_state(state, new):
    """Copy a mixer's new decode state into the carried tensors, leaf by
    leaf: the stack's states are updated in place."""
    if isinstance(state, tuple):
        for s, n in zip(state, new):
            _write_state(s, n)
    else:
        S.copy_into(state, new)
    return state


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
                    local: bool, positions: torch.Tensor, state=None,
                    prefill: bool = False, cache_len: int = 0,
                    pages: torch.Tensor | None = None,
                    backend: str | None = None):
    """Attention of one block (``local``: sliding-window over a ring
    cache). Returns ``(out, state)``: the decode state or the page pools
    updated in place, the prefill state (padded to ``cache_len``, or the
    ring), or ``None``."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = cfg.attn_scale or None

    def proj(w, bname, nh):
        with interpret.scope(w):
            y = mm.matmul(x, p[w], backend)
            if bname in p:
                y = y + p[bname]
        return S.reshape(y, b, s, nh, hd)

    def wo(out):
        with interpret.scope("wo"):
            return mm.matmul(S.reshape(out, b, s, h * hd), p["wo"], backend)

    q = proj("wq", "bq", h)
    k = proj("wk", "bk", kv)
    v = proj("wv", "bv", kv)
    q, k = _rope_qk(cfg, q, k, positions)

    if state is not None and pages is not None:   # ---- paged decode/chunk
        kp, vp = state                            # [P, ps, kv, hd] pools
        pg, off = _page_targets(pages, positions, kp.shape[1])
        S.index_write(kp, (pg, off), k)
        S.index_write(vp, (pg, off), v)
        # on a mesh the gather reads pages of every data shard
        kr_, vr_ = S.unshard_dims(kp, (0,)), S.unshard_dims(vp, (0,))
        if s == 1:
            # a chunk of one token runs the plain version, as prefill does
            out = fused_paged_attention(
                q.contiguous(), kr_, vr_, pages, positions[:, 0] + 1,
                functools.partial(A.decode_attention,
                                  constrain_q=cfg.pos != "mrope"),
                scale=scale, softcap=cfg.attn_softcap,
                backend=backend or "ref")
        else:
            out = A.paged_chunk_attention(
                q, gather_pages(kr_, pages), gather_pages(vr_, pages),
                positions, scale=scale, softcap=cfg.attn_softcap,
                constrain_q=cfg.pos != "mrope")
        return wo(out), (kp, vp)

    if state is not None:                       # ---- single-token decode
        bpos = _decode_batch_pos(cfg, positions)
        rows = torch.arange(b, device=x.device)
        if local:
            kc, vc, slots = state
            slot = bpos % kc.shape[1]
            S.index_write(kc, (rows, slot), k[:, 0])
            S.index_write(vc, (rows, slot), v[:, 0])
            S.index_write(slots, (rows, slot), bpos)
            out = _ring_decode(q, kc, vc, slots, bpos, cfg, scale)
        else:
            kc, vc = state
            S.index_write(kc, (rows, bpos), k[:, 0])
            S.index_write(vc, (rows, bpos), v[:, 0])
            out = A.decode_attention(q, kc, vc, bpos + 1, scale=scale,
                                     softcap=cfg.attn_softcap,
                                     constrain_q=cfg.pos != "mrope")
        return wo(out), state

    if local:
        out = A.sliding_window_attention(q, k, v, window=cfg.window,
                                         scale=scale)
    else:
        out = A.chunked_attention(q, k, v, causal=True, scale=scale,
                                  softcap=cfg.attn_softcap,
                                  block_k=cfg.attn_block_k)
    out = wo(out)
    if not prefill:
        return out, None
    if local:
        # the ring of the last `window` positions; -1 marks an empty slot
        w_sz = cfg.window
        take = min(s, w_sz)
        t = torch.arange(s - take, s, device=x.device)
        ring = t % w_sz
        kc = k.new_zeros((b, w_sz, kv, hd))
        vc = v.new_zeros((b, w_sz, kv, hd))
        slots = torch.full((b, w_sz), -1, dtype=torch.int32,
                           device=x.device)
        kc[:, ring] = k[:, -take:]
        vc[:, ring] = v[:, -take:]
        slots[:, ring] = t.to(torch.int32)
        return out, (kc, vc, slots)
    pad = (b, cache_len - s, kv, hd)
    return out, (torch.cat([k, k.new_zeros(pad)], dim=1),
                 torch.cat([v, v.new_zeros(pad)], dim=1))


def _ring_decode(q, kc, vc, slots, bpos, cfg: ArchConfig, scale):
    """Decode attention over a ring-buffer window cache: slot order does
    not matter to the softmax, validity comes from the stored positions
    (written, not ahead of the row, inside the window)."""
    b, _, h, hd = q.shape
    hkv = kc.shape[2]
    qg = A._group_q(q, hkv)
    scale = scale if scale is not None else hd ** -0.5
    scores = interpret.einsum("bqkrd,bskd->bkrqs", qg, kc).float() * scale
    valid = ((slots >= 0) & (slots <= bpos[:, None])
             & (slots > bpos[:, None] - cfg.window))
    scores = torch.where(valid[:, None, None, None], scores, A.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = interpret.einsum("bkrqs,bskd->bqkrd", probs, vc)
    return out.reshape(b, 1, h, vc.shape[-1])


# --------------------------------------------------------------------- MLA
def mla_scale(cfg: ArchConfig) -> float:
    """MLA's softmax scale: ``(dn + dr) ** -0.5``, times YaRN's
    ``mscale(factor, mscale_all_dim) ** 2`` where the config scales its
    RoPE so (DeepSeek-V2's attention; 1.5896 at its factor 40 and 0.707)."""
    mla = cfg.mla
    scale = (mla.qk_nope_head_dim + mla.qk_rope_head_dim) ** -0.5
    rs = cfg.rope_scaling
    if rs is not None and rs.mscale_all_dim:
        m = L.yarn_get_mscale(rs.factor, rs.mscale_all_dim)
        scale = scale * m * m
    return scale


def apply_mla(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor, state=None, prefill: bool = False,
              cache_len: int = 0, pages: torch.Tensor | None = None,
              backend: str | None = None):
    """Multi-head Latent Attention of one block: the parallel path with
    per-head keys and values expanded from the latent, or the absorbed
    decode over the latent cache ``(ckv [B, T, r], kr [B, T, dr])``
    (written in place). With ``pages [B, MP]`` the state is the latent
    page pools ``(ckv [P, ps, r], kr [P, ps, dr])``: this step's entries
    are scattered into each row's pages (in place), the pages gathered to
    a dense view, and the absorbed decode masked per query (``kpos <=
    position``), which for S = 1 is the dense decode mask and for S > 1
    serves a chunked prefill. The prefill state is the latent cache
    padded to ``cache_len``."""
    mla = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    ein = interpret.einsum

    if mla.q_lora_rank:
        cq = L.rms_norm(mm.matmul(x, p["w_dq"], backend),
                        p["q_norm"]["scale"])
        q = ein("bsr,rhe->bshe", cq, p["w_uq"])
    else:
        q = ein("bsd,dhe->bshe", x, p["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta,
                          cfg.rope_scaling)
    ckv = L.rms_norm(mm.matmul(x, p["w_dkv"], backend),
                     p["kv_norm"]["scale"])
    kr = mm.matmul(x, p["w_kr"], backend)[:, :, None, :]
    kr = L.apply_rope(kr, positions, cfg.rope_theta, cfg.rope_scaling)
    scale = mla_scale(cfg)

    if state is not None:                       # ---- absorbed decode
        if pages is not None:                   # paged: pool-backed cache
            ckv_p, kr_p = state                 # [P, ps, r], [P, ps, dr]
            pg, off = _page_targets(pages, positions, ckv_p.shape[1])
            S.index_write(ckv_p, (pg, off), ckv)
            S.index_write(kr_p, (pg, off), kr[:, :, 0])
            ckv_c = gather_pages(S.unshard_dims(ckv_p, (0,)), pages)
            kr_c = gather_pages(S.unshard_dims(kr_p, (0,)), pages)
            kpos = torch.arange(ckv_c.shape[1], device=x.device)
            # per-query causal mask [B, 1, S, T]; for S == 1 it is the
            # dense decode mask below
            mask = (kpos[None, None, :]
                    <= positions.long()[:, :, None])[:, None]
        else:
            ckv_c, kr_c = state
            bpos = _decode_batch_pos(cfg, positions)
            rows = torch.arange(b, device=x.device)
            S.index_write(ckv_c, (rows, bpos), ckv[:, 0])
            S.index_write(kr_c, (rows, bpos), kr[:, 0, 0])
            kpos = torch.arange(ckv_c.shape[1], device=x.device)
            mask = (kpos[None, :] <= bpos[:, None])[:, None, None, :]
        q_eff = ein("bshe,rhe->bshr", q_nope, p["w_uk"])
        # keep the absorbed query latent-sharded like the cache on a mesh
        q_eff = A._try_constrain(q_eff, (None, None, None, "model"))
        scores = (ein("bshr,btr->bhst", q_eff, ckv_c)
                  + ein("bshe,bte->bhst", q_rope, kr_c)).float()
        scores = scores * scale
        scores = torch.where(mask, scores, A.NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        lat = ein("bhst,btr->bshr", probs, ckv_c)
        out = ein("bshr,rhe->bshe", lat, p["w_uv"])
        return mm.matmul(out.reshape(b, s, h * dv), p["wo"], backend), state

    # ---- parallel: per-head keys and values expanded from the latent
    k_nope = ein("bsr,rhe->bshe", ckv, p["w_uk"])
    value = ein("bsr,rhe->bshe", ckv, p["w_uv"])
    out = A.mla_attention(q_nope, q_rope, k_nope, kr, value, scale=scale,
                          block_k=cfg.attn_block_k)
    out = mm.matmul(out.reshape(b, s, h * dv), p["wo"])
    if not prefill:
        return out, None
    pad = cache_len - s
    return out, (torch.cat([ckv, ckv.new_zeros((b, pad, ckv.shape[-1]))], 1),
                 torch.cat([kr[:, :, 0],
                            kr.new_zeros((b, pad, kr.shape[-1]))], 1))


# ------------------------------------------------------------------- mixers
def apply_mixer(p: dict, x: torch.Tensor, cfg: ArchConfig, mixer: str, *,
                positions: torch.Tensor, state=None, prefill: bool = False,
                cache_len: int = 0, pages: torch.Tensor | None = None,
                backend: str | None = None):
    """One block's mixer: ``(out, state)`` (see the module doc)."""
    if pages is not None and mixer not in ("attn", "mla"):
        raise ValueError(f"paged decode supports position-masked cache "
                         f"mixers (attn/mla) only, not {mixer!r}")
    if mixer in ("attn", "local"):
        return apply_attention(p, x, cfg, local=mixer == "local",
                               positions=positions, state=state,
                               prefill=prefill, cache_len=cache_len,
                               pages=pages, backend=backend)
    if mixer == "mla":
        return apply_mla(p, x, cfg, positions=positions, state=state,
                         prefill=prefill, cache_len=cache_len, pages=pages,
                         backend=backend)
    if mixer == "rglru":
        out, new = R.apply_recurrent_block(p, x, state, want_state=prefill)
        return out, (new if state is None else _write_state(state, new))
    xc = cfg.xlstm
    if mixer == "mlstm":
        if state is not None:
            conv_buf, mem = state
            out, mem, conv_buf = X.mlstm_decode(p, x, xc, conv_buf, mem)
            return out, _write_state(state, (conv_buf, mem))
        out, mem, u = X.apply_mlstm(p, x, xc)
        return out, ((R.conv_tail(u, xc.conv_width), mem) if prefill
                     else None)
    if mixer == "slstm":
        if state is not None:
            conv_buf, cell = state
            out, cell, conv_buf = X.slstm_decode(p, x, xc, conv_buf, cell)
            return out, _write_state(state, (conv_buf, cell))
        out, cell = X.apply_slstm(p, x, xc)
        return out, ((R.conv_tail(x, xc.conv_width), cell) if prefill
                     else None)
    raise ValueError(mixer)


# -------------------------------------------------------------------- block
def _id(a):
    return a


def apply_block(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: str, *,
                positions: torch.Tensor, state=None, prefill: bool = False,
                cache_len: int = 0, pages: torch.Tensor | None = None,
                backend: str | None = None,
                expert_backend: str | None = None, constrain=_id):
    """One block: ``(x, state, aux)``, ``aux`` the MoE's load-balancing
    loss (a float32 zero for a dense block). ``expert_backend`` reaches
    a dropless MoE's routed products (:func:`repro_torch.models.moe.
    apply_moe`). ``constrain`` pins each residual add to the
    sequence-parallel layout on a mesh."""
    mixer, ffn = parse_spec(spec)
    aux = torch.zeros((), device=x.device)
    with spans.span("model.norm"):
        h = L.apply_norm(cfg.norm, p["norm1"], x)
    with interpret.scope(mixer), spans.span("model." + mixer):
        out, new_state = apply_mixer(
            p["mixer"], h, cfg, mixer, positions=positions, state=state,
            prefill=prefill, cache_len=cache_len, pages=pages,
            backend=backend)
    x = constrain(x + L.weak(cfg.resid_mult, out.dtype) * out)
    if ffn == "none":
        return x, new_state, aux
    with spans.span("model.norm"):
        h = L.apply_norm(cfg.norm, p["norm2"], x)
    with interpret.scope(ffn), spans.span("model." + ffn):
        if ffn == "moe":
            y, aux = M.apply_moe(p["ffn"], h, cfg.moe, cfg.act, backend,
                                 expert_backend)
        else:
            y = L.apply_mlp(p["ffn"], h, cfg.act, backend)
    x = constrain(x + L.weak(cfg.resid_mult, y.dtype) * y)
    return x, new_state, aux


# -------------------------------------------------------------------- stack
def apply_stack(layers: list, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, states: list | None = None,
                prefill: bool = False, cache_len: int = 0,
                pages: torch.Tensor | None = None,
                backend: str | None = None,
                expert_backend: str | None = None, constrain=_id):
    """Run every layer. Returns ``(x, states, aux)``: the per-layer states
    for decode and paged steps (updated in place) and prefill, else
    ``None``; and the blocks' load-balancing losses summed in layer
    order, as the JAX package's stack sums them. ``constrain`` is applied
    where the JAX stack applies it: each residual add of the unrolled
    head and tail blocks, and the stream after the head, after each
    pattern group and after the tail."""
    new_states = [] if (states is not None or prefill) else None
    aux_total = torch.zeros((), device=x.device)
    n_head, n_pat = len(cfg.head), len(cfg.pattern)
    n_body = cfg.n_groups * n_pat
    if not n_head:
        x = constrain(x)            # the JAX stack's constraint after head
    for i, (p, spec) in enumerate(zip(layers, cfg.block_specs)):
        body = n_head <= i < n_head + n_body
        with _layer_scope(cfg, i):
            x, st, aux = apply_block(
                p, x, cfg, spec, positions=positions,
                state=None if states is None else states[i],
                prefill=prefill, cache_len=cache_len, pages=pages,
                backend=backend, expert_backend=expert_backend,
                constrain=_id if body else constrain)
        if i == n_head - 1 or (body and (i - n_head) % n_pat == n_pat - 1):
            x = constrain(x)
        aux_total = aux_total + aux
        if new_states is not None:
            new_states.append(st)
    return constrain(x), new_states, aux_total


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
