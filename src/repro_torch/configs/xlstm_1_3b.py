"""xLSTM-1.3B [arXiv:2405.04517]: mLSTM + sLSTM blocks at the paper's 7:1
ratio (48 layers = 6 groups of 7 mLSTM + 1 sLSTM); no external FFN
(d_ff=0 -- the blocks carry their own projections)."""
from repro_torch.models.config import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    xlstm=XLSTMConfig(heads=4, chunk=256, mlstm_proj_factor=2.0,
                      slstm_proj_factor=4.0 / 3.0, conv_width=4),
    pos="rope",               # positions only used by conv/recurrence: none
    subquadratic=True,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                     vocab=256, pattern=("mlstm", "slstm"),
                     xlstm=XLSTMConfig(heads=2, chunk=8,
                                       mlstm_proj_factor=2.0,
                                       slstm_proj_factor=4.0 / 3.0,
                                       conv_width=4))
