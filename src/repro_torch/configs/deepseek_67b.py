"""DeepSeek-67B [arXiv:2401.02954]: llama-arch dense, GQA kv=8, 95 layers."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400,
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=256, attn_block_k=32,
                     tail=("attn+mlp",))  # exercise 95 = 47*2+1 style tail
