"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: MLA attention (q_lora 768,
kv_lora 256), mu-P multipliers (scale_emb 12, scale_depth 1.4)."""
from repro_torch.models.config import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448,
    pattern=("mla+mlp",),
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    tie_embeddings=True,
    emb_mult=12.0, resid_mult=1.4 / (62 ** 0.5),
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=128, vocab=256, attn_block_k=32,
                     resid_mult=1.4 / (2 ** 0.5),
                     mla=MLAConfig(kv_lora_rank=16, q_lora_rank=24,
                                   qk_nope_head_dim=8, qk_rope_head_dim=4,
                                   v_head_dim=8))
