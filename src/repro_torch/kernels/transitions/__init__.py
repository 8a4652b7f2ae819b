"""Streaming bit-transition counter (K5): ``csrc/transitions.cu`` holds
the Hopper kernel, ``ref.py`` its plain PyTorch version, ``ops.py`` the
entry point that picks between them."""
from .ops import count_transitions  # noqa: F401
