"""Grouped-query attention: the causal prefill attention (online softmax
over KV blocks), sliding-window attention over gathered per-block KV
windows, single-token decode against a KV cache, the multi-token causal
attention of a chunked prefill over a row's paged history (gathered by
:func:`repro_torch.kernels.zvg_matmul.ref.gather_pages`), and the score
path of Multi-head Latent Attention (MLA, DeepSeek-V2).

GQA is computed in grouped form -- q reshaped to ``[B, S, Hkv, rep, D]``
and contracted against the un-repeated K/V. Scores are float32; the
probabilities are cast back to q's dtype before they meet V, as in the
JAX package. These are plain tensor code there too (no Pallas kernel).
Every einsum goes through :func:`repro_torch.trace.interpret.einsum`, the
tracer's seam (plain ``torch.einsum`` with no trace running), and the
prefill's loop over KV blocks names each block's frame ``scan[j]``, as the
JAX package's ``lax.scan`` does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.runtime import sharding as rsh
from repro_torch.runtime import spmd
from repro_torch.trace import interpret

NEG_INF = -1e30


def _group_q(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """``[B, S, H, D] -> [B, S, Hkv, rep, D]``."""
    b, s, h, d = q.shape
    return spmd.reshape(q, b, s, hkv, h // hkv, d)


def _try_constrain(x, spec):
    """Best-effort sharding constraint: ``x`` redistributed to ``spec``
    (an entry a mesh axis name, a tuple of them, ``None``, or the
    sentinel ``"dp"``, which resolves to ``("pod", "data")``, then
    ``"data"``, then replicated) on the mesh of the DTensor ``x``; a
    plain tensor, or a spec whose axes the mesh lacks, passes as it is
    -- the JAX package's ``_try_constrain``."""
    if not spmd.is_dist(x):
        return x
    mesh = x.device_mesh
    names = set(mesh.mesh_dim_names or ())
    for dpv in (("pod", "data"), "data", None):
        s = [dpv if e == "dp" else e for e in spec]
        axes = [a for e in s if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        if all(a in names for a in axes):
            want = rsh.placements(mesh, rsh.P(*s))
            if list(x.placements) == want:
                return x
            return x.redistribute(mesh, want)
    return x


def tp_heads_constrain(x):
    """Pin a projected ``[B, S, H, D]`` tensor to (batch=dp,
    heads=model): the project-then-gather layout of the JAX package's
    ``tp_heads_constrain`` (defined there and here, called by neither
    stack)."""
    return _try_constrain(x, ("dp", None, "model", None))


def _softcap(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    if softcap > 0:
        return torch.tanh(scores / softcap) * softcap
    return scores


def chunked_attention(q, k, v, *, causal: bool = True, scale=None,
                      softcap: float = 0.0, block_k: int = 1024):
    """Flash-style causal attention, ``[B, S, H, D] -> [B, S, H, Dv]``:
    a loop over KV blocks of ``block_k`` with online softmax."""
    b, sq, h, d = q.shape
    dv, hkv, sk = v.shape[-1], k.shape[2], k.shape[1]
    rep = h // hkv
    qg = _group_q(q, hkv)
    scale = scale if scale is not None else d ** -0.5
    bk = min(block_k, sk)
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, rep, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, rep, sq), device=q.device)
    acc = torch.zeros((b, hkv, rep, sq, dv), device=q.device)
    for j0 in range(0, sk, bk):
        kj, vj = k[:, j0:j0 + bk], v[:, j0:j0 + bk]
        if kj.shape[1] < bk:                      # zero-padded last block
            pad = bk - kj.shape[1]
            kj = torch.cat([kj, kj.new_zeros((b, pad) + kj.shape[2:])], 1)
            vj = torch.cat([vj, vj.new_zeros((b, pad) + vj.shape[2:])], 1)
        with interpret.scope(f"scan[{j0 // bk}]"):
            s_blk = interpret.einsum("bqkrd,bskd->bkrqs", qg,
                                     kj).float() * scale
            s_blk = _softcap(s_blk, softcap)
            kpos = j0 + torch.arange(bk, device=q.device)
            mask = (kpos < sk)[None, :]
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            s_blk = torch.where(mask, s_blk, NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + interpret.einsum(
                "bkrqs,bskd->bkrqd", p.to(q.dtype), vj).float()
            m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]      # [B,kv,rep,S,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def sliding_window_attention(q, k, v, *, window: int, scale=None,
                             block_q: int = 1024):
    """Local causal attention, ``[B, S, H, D] -> [B, S, H, Dv]``: each
    query block of ``block_q`` attends to its gathered ``window +
    block_q`` KV neighbourhood, masked to the ``window`` positions at or
    before each query."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    bq = min(block_q, s)
    nb = -(-s // bq)
    pad = nb * bq - s
    if pad:
        q, k, v = (torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], 1)
                   for t in (q, k, v))
    dev = q.device
    idx = (torch.arange(nb, device=dev)[:, None] * bq - window
           + torch.arange(window + bq, device=dev)[None, :])  # [nb, span]
    valid = idx >= 0
    idx = torch.clamp(idx, 0, nb * bq - 1)
    kw, vw = k[:, idx], v[:, idx]                # [B, nb, span, Hkv, D]
    qb = _group_q(q, hkv).reshape(b, nb, bq, hkv, h // hkv, d)
    scores = interpret.einsum("bnqkrd,bnskd->bnkrqs", qb,
                              kw).float() * scale
    qpos = torch.arange(nb * bq, device=dev).reshape(nb, bq)
    kpos = idx
    mask = ((qpos[:, :, None] >= kpos[:, None, :])
            & (qpos[:, :, None] - kpos[:, None, :] < window)
            & valid[:, None, :] & (kpos[:, None, :] < s))
    scores = torch.where(mask[None, :, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = interpret.einsum("bnkrqs,bnskd->bnqkrd", probs, vw)
    return out.reshape(b, nb * bq, h, v.shape[-1])[:, :s]


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None,
                     softcap: float = 0.0, constrain_q: bool = True):
    """Single-token decode: ``q [B, 1, H, D]`` against ``[B, Smax, Hkv,
    D]`` caches holding ``cache_len [B]`` valid entries per row."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = _group_q(q, hkv)
    # on a mesh, q takes the cache's layout (head dim over "model"): the
    # score contraction is partial sums, not a gather of the cache
    if constrain_q:
        qg = _try_constrain(qg, (None, None, None, None, "model"))
    scale = scale if scale is not None else d ** -0.5
    scores = interpret.einsum("bqkrd,bskd->bkrqs", qg,
                              k_cache).float() * scale
    scores = _softcap(scores, softcap)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, :] < cache_len[:, None]            # [B, Smax]
    scores = torch.where(mask[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    # on a mesh the (small) probabilities are gathered but for the batch
    # dim, so the product meets the cache in its own layout
    probs = spmd.unshard_dims(probs, (1, 2, 3, 4))
    out = interpret.einsum("bkrqs,bskd->bqkrd", probs, v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


def paged_chunk_attention(q, k_cache, v_cache, positions_q, *, scale=None,
                          softcap: float = 0.0, constrain_q: bool = True):
    """Multi-token causal attention of a paged prefill chunk: ``q [B, C,
    H, D]`` against gathered caches ``[B, Smax, Hkv, D]``. Query ``i``
    sits at absolute position ``positions_q[b, i]`` and attends to cache
    positions at or before it; the chunk's own keys were written to the
    pool before the gather, so one mask covers the chunk and the history.
    Negative positions mark right padding: their rows are fully masked
    (finite junk that no caller reads)."""
    b, sq, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = _group_q(q, hkv)
    if constrain_q:
        qg = _try_constrain(qg, (None, None, None, None, "model"))
    scale = scale if scale is not None else d ** -0.5
    scores = interpret.einsum("bqkrd,bskd->bkrqs", qg,
                              k_cache).float() * scale
    scores = _softcap(scores, softcap)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, None, :] <= positions_q[:, :, None]   # [B, C, Smax]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = interpret.einsum("bkrqs,bskd->bqkrd", probs, v_cache)
    return out.reshape(b, sq, h, v_cache.shape[-1])


# ----------------------------------------------------------------- MLA ----
@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 family)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


def mla_attention(q_nope, q_rope, k_nope, k_rope, value, *,
                  causal: bool = True, block_k: int = 1024,
                  scale: float | None = None):
    """MLA's parallel score path: per-head nope and rope parts of the
    queries and keys concatenated, the rope key ``[B, S, 1, Dr]`` shared
    by every head, then :func:`chunked_attention` scaled by ``scale``
    (by default the concatenated head dim's ``** -0.5``).
    ``q_nope``/``k_nope [B, S, H, Dn]``, ``q_rope [B, S, H, Dr]``,
    ``value [B, S, H, Dv]``."""
    h = q_nope.shape[2]
    k_rope = k_rope.expand(k_rope.shape[:2] + (h, k_rope.shape[-1]))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    if scale is None:
        scale = (q_nope.shape[-1] + q_rope.shape[-1]) ** -0.5
    return chunked_attention(q, k, value, causal=causal, scale=scale,
                             block_k=block_k)
