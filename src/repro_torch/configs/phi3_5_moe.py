"""Phi-3.5-MoE (42B total / 6.6B active)
[hf:microsoft/Phi-3.5-MoE-instruct]: 16 experts, top-2, GQA kv=8."""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064,
    pattern=("attn+moe",),
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=6400,
                  capacity_factor=1.25, group_size=512),
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=256, attn_block_k=32,
                     moe=MoEConfig(num_experts=4, top_k=2, expert_ff=64,
                                   capacity_factor=1.25, group_size=16))
