"""Grouped-query attention: the causal prefill attention (online softmax
over KV blocks), single-token decode against a KV cache, and the
multi-token causal attention of a chunked prefill over a row's paged
history (gathered by :func:`repro_torch.kernels.zvg_matmul.ref.
gather_pages`).

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

import torch

from repro_torch.trace import interpret

NEG_INF = -1e30


def _group_q(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """``[B, S, H, D] -> [B, S, Hkv, rep, D]``."""
    b, s, h, d = q.shape
    return q.reshape(b, s, hkv, h // hkv, d)


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


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None,
                     softcap: float = 0.0):
    """Single-token decode: ``q [B, 1, H, D]`` against ``[B, Smax, Hkv,
    D]`` caches holding ``cache_len [B]`` valid entries per row."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = _group_q(q, hkv)
    scale = scale if scale is not None else d ** -0.5
    scores = interpret.einsum("bqkrd,bskd->bkrqs", qg,
                              k_cache).float() * scale
    scores = _softcap(scores, softcap)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, :] < cache_len[:, None]            # [B, Smax]
    scores = torch.where(mask[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = interpret.einsum("bkrqs,bskd->bqkrd", probs, v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


def paged_chunk_attention(q, k_cache, v_cache, positions_q, *, scale=None,
                          softcap: float = 0.0):
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
