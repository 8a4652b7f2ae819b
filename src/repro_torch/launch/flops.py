"""Analytic parameter / FLOP model per architecture.

MODEL_FLOPS convention (per the roofline spec):
  train  : 6 * N * T        (N = non-embedding params; MoE: N_active)
  prefill: 2 * N * T
  decode : 2 * N * T        (T = generated tokens = global_batch here)
plus the causal attention term reported separately
(2 * 2 * L_attn * B * S^2/2 * H * hd for scores+values, causal-half
convention); recurrent/linear mixers have no quadratic term.

This model is the cross-check for the dry-run's graph-derived numbers
(:mod:`repro_torch.launch.graph_analysis`): the MODEL_FLOPS / counted
FLOPs ratio quantifies masked-attention and dispatch overhead in the
step as it runs.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import parse_spec


def _mixer_params(cfg: ArchConfig, mixer: str) -> float:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if mixer in ("attn", "local"):
        return d * h * hd + 2 * d * kv * hd + h * hd * d
    if mixer == "mla":
        m = cfg.mla
        n = d * m.kv_lora_rank + d * m.qk_rope_head_dim
        n += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
        if m.q_lora_rank:
            n += d * m.q_lora_rank + m.q_lora_rank * h * (
                m.qk_nope_head_dim + m.qk_rope_head_dim)
        else:
            n += d * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
        n += h * m.v_head_dim * d
        return n
    if mixer == "rglru":
        w = cfg.rglru.lru_width or d
        return 2 * d * w + 2 * w * w + cfg.rglru.conv_width * w + w * d
    if mixer == "mlstm":
        x = cfg.xlstm
        di = int(d * x.mlstm_proj_factor)
        return (2 * d * di + 3 * di * di + 2 * di * x.heads
                + x.conv_width * di + di * d)
    if mixer == "slstm":
        x = cfg.xlstm
        dh = d // x.heads
        f = int(d * x.slstm_proj_factor)
        return (x.conv_width * d + 4 * d * d + x.heads * dh * 4 * dh
                + 2 * d * f + f * d)
    raise ValueError(mixer)


def _ffn_params(cfg: ArchConfig, ffn: str) -> tuple[float, float]:
    """(total, active) params of the ffn part."""
    d = cfg.d_model
    if ffn == "none":
        return 0.0, 0.0
    if ffn == "moe":
        m = cfg.moe
        per = (3 if cfg.mlp_gated else 2) * d * m.expert_ff
        total = m.num_experts * per + d * m.num_experts  # + router
        active = m.top_k * per
        if m.num_shared:
            sh = (3 if cfg.mlp_gated else 2) * d * (m.shared_ff
                                                    or m.expert_ff)
            total += sh
            active += sh
        return total, active
    per = (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
    return per, per


def param_counts(cfg: ArchConfig) -> dict:
    """{"total", "active", "embed"} parameter counts."""
    specs = (list(cfg.head) + list(cfg.pattern) * cfg.n_groups
             + list(cfg.tail))
    total = active = 0.0
    for s in specs:
        mixer, ffn = parse_spec(s)
        mp = _mixer_params(cfg, mixer)
        ft, fa = _ffn_params(cfg, ffn)
        total += mp + ft
        active += mp + fa
    embed = cfg.vocab * cfg.d_model * (cfg.codebooks or 1)
    head = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model * (
        cfg.codebooks or 1)
    if cfg.inputs == "embeds":
        embed = cfg.vocab * cfg.d_model   # unembed only; frontend stubbed
    return {"total": total, "active": active, "embed": embed + head}


def attention_flops(cfg: ArchConfig, seq: int, batch: int,
                    kind: str) -> float:
    """Causal-half score+value FLOPs of all attention layers (forward)."""
    specs = (list(cfg.head) + list(cfg.pattern) * cfg.n_groups
             + list(cfg.tail))
    fl = 0.0
    for s in specs:
        mixer, _ = parse_spec(s)
        if mixer == "attn":
            eff = seq if kind != "decode" else seq  # decode: q=1 vs cache S
            if kind == "decode":
                fl += 2 * 2 * batch * eff * cfg.n_heads * cfg.hd
            else:
                fl += 2 * 2 * batch * eff * eff / 2 * cfg.n_heads * cfg.hd
        elif mixer == "local":
            w = cfg.window
            if kind == "decode":
                fl += 2 * 2 * batch * min(w, seq) * cfg.n_heads * cfg.hd
            else:
                fl += 2 * 2 * batch * seq * min(w, seq) * cfg.n_heads \
                    * cfg.hd
        elif mixer == "mla":
            m = cfg.mla
            dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
            eff = seq
            if kind == "decode":
                fl += 2 * batch * eff * cfg.n_heads * (dqk
                                                       + m.v_head_dim)
            else:
                fl += 2 * batch * eff * eff / 2 * cfg.n_heads * (
                    dqk + m.v_head_dim)
    return fl


def model_flops(cfg: ArchConfig, seq: int, batch: int, kind: str) -> dict:
    """MODEL_FLOPS for one step of a cell."""
    pc = param_counts(cfg)
    n = pc["active"]
    if kind == "train":
        tokens = batch * seq
        dense = 6.0 * n * tokens
        attn = 3.0 * attention_flops(cfg, seq, batch, kind)
        # embedding/unembed matmul flops (unembed only; gather is free)
        head = 6.0 * pc["embed"] / (2 if not cfg.tie_embeddings else 1) \
            * tokens / (cfg.codebooks or 1)
    elif kind == "prefill":
        tokens = batch * seq
        dense = 2.0 * n * tokens
        attn = attention_flops(cfg, seq, batch, kind)
        head = 2.0 * batch * cfg.d_model * cfg.vocab  # last position only
    else:  # decode: one token per sequence
        tokens = batch
        dense = 2.0 * n * tokens
        attn = attention_flops(cfg, seq, batch, kind)
        head = 2.0 * batch * cfg.d_model * cfg.vocab * (cfg.codebooks or 1)
    return {"dense": dense, "attention": attn, "head": head,
            "total": dense + attn + head,
            "params_total": pc["total"], "params_active": pc["active"],
            "params_embed": pc["embed"]}
