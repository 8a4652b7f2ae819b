"""The serving decode path's kernels: the ZVG-gated row matmul (K2) and
the matmul fused with its decode streams' power counters (K3).
``csrc/zvg_matmul.cu`` holds the Hopper kernels, ``ref.py`` their plain
PyTorch versions, ``ops.py`` the entry points that pick between them."""
from .ops import fused_matmul_counters, gated_row_matmul  # noqa: F401
