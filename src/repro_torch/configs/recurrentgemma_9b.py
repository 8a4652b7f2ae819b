"""RecurrentGemma-9B [arXiv:2402.19427 Griffin]: RG-LRU recurrent blocks +
local (window 2048) MQA attention at 1:2 ratio; 38 layers = 12 x
(rec, rec, attn) + 2 x rec tail. Gemma conventions: sqrt(width) embedding
scale, GeGLU MLP, logit softcap 30."""
from repro_torch.models.config import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000,
    pattern=("rglru+mlp", "rglru+mlp", "local+mlp"),
    tail=("rglru+mlp", "rglru+mlp"),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, window=2048),
    window=2048,
    act="gelu", emb_mult=64.0, logit_softcap=30.0,
    rope_theta=10000.0,
    subquadratic=True,
)

SMOKE = CONFIG.with_(n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
                     d_ff=128, vocab=256, emb_mult=8.0, window=16,
                     attn_block_k=32,
                     rglru=RGLRUConfig(lru_width=64, conv_width=4,
                                       window=16))
