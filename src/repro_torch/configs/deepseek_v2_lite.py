"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434]:
MLA (kv_lora 512, no q-lora) + MoE with 64 routed experts top-6 and 2
shared experts; the first layer uses a dense FFN (first_k_dense_replace=1).

``CONFIG`` is the published model (``deepseek-ai/DeepSeek-V2-Lite``'s
``config.json``) as it is served: YaRN RoPE scaling (factor 40 over 4096
original positions, ``beta_fast`` 32, ``beta_slow`` 1, ``mscale`` =
``mscale_all_dim`` = 0.707) and dropless routing (greedy softmax top-6,
the gates unnormalised, ``routed_scaling_factor`` 1). The power
accountant streams the dense layer 0 (``wq`` and its MLP's ``up``,
``monitor_block`` 0) where the JAX package's rule takes layer 1, an MoE
block whose FFN has no ``up`` (``wq`` alone). The JAX package states none
of these; its fields are the JAX package's config otherwise.
``SMOKE`` is the JAX package's smoke config (plain RoPE, capacity
routing), which the parity tests hold; ``SERVED_SMOKE`` is the served
mechanisms at smoke widths: the dense first layer, shared experts, 8
routed experts top-3, and YaRN over 64 original positions, so that the
ramp falls inside a short test sequence.

One layout departure from the published code: the port rotates the rotary
part's halves, where the published ``apply_rotary_pos_emb`` first
de-interleaves the pairs of its input (``view(..., d // 2, 2).transpose``)
-- a fixed permutation of the columns of the rotary projections (``wq``'s
rope part, ``w_kr``), so a checkpoint's weights would be permuted once on
loading and the model is the same.
"""
from repro_torch.models.config import (ArchConfig, MLAConfig, MoEConfig,
                                       RopeScaling)

#: the published ``rope_scaling`` (``type: "yarn"``)
YARN = RopeScaling(factor=40.0, original_max_position_embeddings=4096,
                   beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                   mscale_all_dim=0.707)

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400,
    head=("mla+mlp",),               # layer 0: dense FFN
    pattern=("mla+moe",),            # layers 1..26: MoE
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, expert_ff=1408,
                  num_shared=2, shared_ff=2816,
                  capacity_factor=1.25, group_size=512, dropless=True),
    rope_theta=10000.0,
    rope_scaling=YARN,
    monitor_block=0,
)

SMOKE = CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=192, vocab=256, attn_block_k=32,
                     rope_scaling=None, monitor_block=-1,
                     mla=MLAConfig(kv_lora_rank=16, q_lora_rank=0,
                                   qk_nope_head_dim=8, qk_rope_head_dim=4,
                                   v_head_dim=8),
                     moe=MoEConfig(num_experts=4, top_k=2, expert_ff=32,
                                   num_shared=1, shared_ff=64,
                                   capacity_factor=1.25, group_size=16))

SERVED_SMOKE = SMOKE.with_(
    monitor_block=0,
    rope_scaling=RopeScaling(factor=40.0, original_max_position_embeddings=64,
                             beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                             mscale_all_dim=0.707),
    mla=MLAConfig(kv_lora_rank=16, q_lora_rank=0, qk_nope_head_dim=8,
                  qk_rope_head_dim=8, v_head_dim=8),
    moe=MoEConfig(num_experts=8, top_k=3, expert_ff=32, num_shared=2,
                  shared_ff=64, dropless=True))
