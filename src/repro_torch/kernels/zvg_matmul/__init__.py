"""The serving decode path's kernels: the ZVG-gated row matmul (K2), the
matmul fused with its decode streams' power counters (K3), and the paged
decode attention (K4). ``csrc/zvg_matmul.cu`` and
``csrc/paged_attention.cu`` hold the Hopper kernels, ``ref.py`` their
plain PyTorch versions, ``ops.py`` the entry points that pick between
them, ``cases.py`` the cases and tolerance K4 is held to on the card."""
from .ops import (fused_matmul_counters, fused_paged_attention,  # noqa: F401
                  gated_row_matmul)
