"""Qwen2-VL-72B [arXiv:2409.12191]: text backbone with M-RoPE (sections
t/h/w = 16/24/24 frequency bands) and QKV bias. The vision frontend is a
STUB per the assignment: the model takes precomputed patch embeddings
and 3-component positions."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    qkv_bias=True, pos="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    inputs="embeds",
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=256, attn_block_k=32,
                     mrope_sections=(4, 2, 2))
