"""Kernels written by hand for Hopper, each beside its plain PyTorch
version (``_build`` compiles the CUDA sources under ``csrc/``). The
public entry points are the JAX package's ``repro.kernels`` exports.
Each CUDA wrapper counts its calls in its ``launches`` attribute;
:func:`launch_counts` reads all eight, and K2's wide-route calls."""
from .bic_encode.ops import bic_encode  # noqa: F401
from .power_counters.ops import edge_counters  # noqa: F401
from .power_counters.spec import CounterSpec  # noqa: F401
from .transitions.ops import count_transitions  # noqa: F401
from .zvg_matmul.ops import zvg_matmul  # noqa: F401


def launch_counts() -> dict[str, int]:
    """Calls of each CUDA wrapper so far, by kernel id: K1 the counter
    pass (``counters_kernel``), K2 the gated row matmul and K3 the fused
    matmul + counters (one call, a ``stream_kernel`` and a ``walk_kernel``
    launch), K4 paged attention, K5 transitions, K6 BIC encoding, K7 the
    tiled gated matmul, K8 the grouped gated expert product
    (``expert_kernel``); ``k2_wide`` the K2 calls that took its
    tensor-core route (counted in ``k2`` too). The counts are the wrappers' ``launches``
    attributes, read where they are at the call (a caller may reset or
    swap them)."""
    from .bic_encode import kernel as k6
    from .expert_matmul import kernel as k8
    from .power_counters import kernel as k1
    from .transitions import kernel as k5
    from .zvg_matmul import kernel as kz

    return {"k1": k1.fused_counters_cuda.launches,
            "k2": kz.gated_row_matmul_cuda.launches,
            "k2_wide": kz.gated_row_matmul_cuda.wide_launches,
            "k3": kz.fused_matmul_counters_cuda.launches,
            "k4": kz.fused_paged_attention_cuda.launches,
            "k5": k5.transitions_cuda.launches,
            "k6": k6.bic_encode_cuda.launches,
            "k7": kz.zvg_matmul_cuda.launches,
            "k8": k8.expert_matmul_cuda.launches}
