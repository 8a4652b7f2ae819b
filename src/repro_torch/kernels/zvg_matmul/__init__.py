"""The serving decode path's kernels: the ZVG-gated row matmul (K2), the
matmul fused with its decode streams' power counters (K3), and the paged
decode attention (K4); and the tile-gated matmul of the quickstart path
(K7). ``csrc/zvg_matmul.cu``, ``csrc/paged_attention.cu`` and
``csrc/zvg_tiled_matmul.cu`` hold the Hopper kernels, ``ref.py`` their
plain PyTorch versions, ``ops.py`` the entry points that pick between
them, ``cases.py`` the cases and tolerances K4 and K7 are held to on the
card."""
from .ops import (fused_matmul_counters, fused_paged_attention,  # noqa: F401
                  gated_row_matmul, zvg_matmul)
