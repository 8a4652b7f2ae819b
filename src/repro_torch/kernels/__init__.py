"""Kernels written by hand for Hopper, each beside its plain PyTorch
version (``_build`` compiles the CUDA sources under ``csrc/``). The
public entry points are the JAX package's ``repro.kernels`` exports."""
from .bic_encode.ops import bic_encode  # noqa: F401
from .power_counters.ops import edge_counters  # noqa: F401
from .power_counters.spec import CounterSpec  # noqa: F401
from .transitions.ops import count_transitions  # noqa: F401
from .zvg_matmul.ops import zvg_matmul  # noqa: F401
