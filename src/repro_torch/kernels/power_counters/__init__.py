"""Fused power counters: the whole design-menu counter set in one pass per
operand edge (``spec.py`` for the row layout, ``csrc/power_counters.cu``
for the Hopper kernel, ``ref.py`` for its plain PyTorch version)."""
from .ops import BACKENDS, edge_counters, resolve_backend  # noqa: F401
from .spec import CounterSpec  # noqa: F401
