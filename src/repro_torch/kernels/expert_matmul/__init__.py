"""K8, the grouped gated expert product of a dropless mixture of experts:
one launch computes a projection over every expert's segment of rows
(sorted by expert), the gate and up projections of the gated MLP sharing
one launch with the activation in its epilogue. ``csrc/expert_matmul.cu``
holds the Hopper kernel, ``ref.py`` its plain PyTorch version, ``ops.py``
the entry point that picks between them."""
from .ops import expert_matmul  # noqa: F401
