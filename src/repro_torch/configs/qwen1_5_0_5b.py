"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: dense, QKV bias, tied embeddings."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=128, vocab=256, attn_block_k=32)
