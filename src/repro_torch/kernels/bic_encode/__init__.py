"""Single-segment bus-invert encoder (K6): ``csrc/bic_encode.cu`` holds
the Hopper kernel, ``ref.py`` its plain PyTorch version, ``ops.py`` the
entry point that picks between them."""
from .ops import bic_encode  # noqa: F401
