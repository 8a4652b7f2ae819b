"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434]:
MLA (kv_lora 512, no q-lora) + MoE with 64 routed experts top-6 and 2
shared experts; the first layer uses a dense FFN (first_k_dense_replace=1).
"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

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
                  capacity_factor=1.25, group_size=512),
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=192, vocab=256, attn_block_k=32,
                     mla=MLAConfig(kv_lora_rank=16, q_lora_rank=0,
                                   qk_nope_head_dim=8, qk_rope_head_dim=4,
                                   v_head_dim=8),
                     moe=MoEConfig(num_experts=4, top_k=2, expert_ff=32,
                                   num_shared=1, shared_ff=64,
                                   capacity_factor=1.25, group_size=16))
