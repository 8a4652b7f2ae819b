"""MusicGen-medium [arXiv:2306.05284]: decoder-only transformer over
EnCodec tokens (4 codebooks x 2048 codes), LayerNorm + non-gated GELU MLP,
sinusoidal positions. The EnCodec frontend and text conditioning are STUBS
per the assignment (backbone only); K output heads predict the next code
of each stream (delay pattern applied by the data pipeline)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    norm="ln", act="gelu", mlp_gated=False,
    pos="sinusoidal",
    inputs="codes", codebooks=4,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=128, vocab=64, codebooks=2, attn_block_k=32)
