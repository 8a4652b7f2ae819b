"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base]: GQA kv=8 with
mu-P-style multipliers (embedding 12, residual 0.22, attention 1/64,
logits 1/8)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155,
    tie_embeddings=True, rope_theta=10000.0,
    emb_mult=12.0, resid_mult=0.22, attn_scale=0.015625,
    logit_mult=0.125,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=256, attn_block_k=32)
