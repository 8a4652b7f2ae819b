"""Operations and bytes of the port's kernels and of whole steps, computed
from shapes: the yardstick of the roofline and ``mfu`` metrics. Each
input byte is read once and each output byte written once, whatever the
kernel reads again (the kernel table of ``PERF.md`` and
``chip_smoke.py::launch_cost`` count them so; frozen here as of this
benchmark's first version).

A roofline share is the least time the chip could take -- the larger of
the operations over their peak and the bytes over the HBM bandwidth --
over the time measured.
"""
from __future__ import annotations

from ..reference import counters as C
from ..reference import sa
from . import core, peaks

ROWS = COLS = 16


def _pad(n: int, m: int) -> int:
    return n + (-n) % m


def n_rows(bic_variants: tuple, zvg: bool) -> int:
    return len(C.rows(bic_variants, zvg))


def k1_launch(B: int, T: int, L: int, rows: int) -> tuple[float, float]:
    """``(bytes, integer ops)`` of one K1 launch over ``B`` streams of
    ``T`` cycles and ``L`` lanes of 16-bit words with ``rows`` counter
    rows: each word read once, every counter and the per-cycle zero
    counts written once, one accumulate a row a word."""
    return (2.0 * B * T * L + 4.0 * B * (rows * L + T),
            float(B) * T * L * rows)


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / ops_per_s)


# ------------------------------------------------------------------ CNN
def cnn_sites(config: dict, batch: int) -> list[tuple[str, int, int, int]]:
    """``(name, M, K, N)`` of every matmul site of the configuration's
    network at ``batch`` images, from its reference's layer table."""
    return core.reference(config).site_shapes(batch, config["resolution"])


def cnn_k1_call(config: dict, batch: int) -> tuple[float, float]:
    """K1's ``(bytes, ops)`` over one analysis call: two launches a site,
    the West stream ``[K, pad16(M)]`` and the North ``[K, pad16(N)]``,
    with the design menu's counter rows."""
    m = sa.menu(sa.designs(config["designs"]))
    rw = n_rows(m["west_bic"], m["west_zvg"])
    rn = n_rows(m["north_bic"], m["north_zvg"])
    nbytes = ops = 0.0
    for _, M, K, N in cnn_sites(config, batch):
        for L, r in ((_pad(M, ROWS), rw), (_pad(N, COLS), rn)):
            b, o = k1_launch(1, K, L, r)
            nbytes += b
            ops += o
    return nbytes, ops


def cnn_flops(config: dict, batch: int) -> float:
    """2 x the forward's multiply-accumulates over its matmul sites."""
    return 2.0 * sum(M * K * N for _, M, K, N in cnn_sites(config, batch))


# -------------------------------------------------------------- serving
# The shapes of a language model come from its configuration's reference
# module (``decode_products``, ``accountant_sites``, ``matmul_params``):
# what follows is the same for every architecture.
def lm_weights(cfg: dict) -> list[tuple[int, int]]:
    """``(K, N)`` of every product the decode step runs through the gated
    row matmul (K2), in the order one step launches them."""
    return core.reference(cfg).decode_products(cfg)


def k2_step(cfg: dict, rows: int) -> tuple[float, float]:
    """K2's ``(bytes, flops)`` over one decode step at ``rows`` rows:
    bfloat16 in and out."""
    nbytes = flops = 0.0
    for K, N in lm_weights(cfg):
        nbytes += 2.0 * (rows * K + K * N + rows * N)
        flops += 2.0 * rows * K * N
    return nbytes, flops


def k2_launches(cfg: dict) -> int:
    return len(lm_weights(cfg))


def accountant_sites(cfg: dict) -> list[tuple[int, int]]:
    """``(K, N)`` of the accountant's monitored weights."""
    return core.reference(cfg).accountant_sites(cfg)


def k3_call(B: int, K: int, N: int) -> tuple[float, float]:
    """K3's ``(bytes, ops)`` for one sampled decode site: the product of
    ``[B, K]`` and ``[K, N]`` (bfloat16) and the counters of its streams
    (one west stream a row, 16 lanes; the north stream ``pad16(N)``
    lanes), sub-sampled as the accountant streams them."""
    K, N = min(K, 1024), min(N, 256)
    pp = sa.PAPER_PAIR
    m = sa.menu(pp)
    rw = n_rows(m["west_bic"], m["west_zvg"])
    rn = n_rows(m["north_bic"], m["north_zvg"])
    Np = _pad(N, COLS)
    nbytes = (2.0 * B * K + 2.0 * K * N
              + 4.0 * (B * N + B * rw * ROWS + B * K + rn * Np + K))
    ops = 2.0 * B * K * N + B * K * ROWS * rw + K * Np * rn
    return nbytes, ops


def k3_step(cfg: dict, rows: int) -> tuple[float, float]:
    nbytes = ops = 0.0
    for K, N in accountant_sites(cfg):
        b, o = k3_call(rows, K, N)
        nbytes += b
        ops += o
    return nbytes, ops


def k1_admission(cfg: dict, prompt_rows: int) -> tuple[float, float]:
    """K1's ``(bytes, ops)`` for one admission's prompt accounting: per
    monitored site a West launch ``[min(K, 1024), pad16(ms)]`` (``ms``
    the power of two of at most 256 rows) and a North launch
    ``[min(K, 1024), pad16(min(N, 256))]``."""
    m = sa.menu(sa.PAPER_PAIR)
    rw = n_rows(m["west_bic"], m["west_zvg"])
    rn = n_rows(m["north_bic"], m["north_zvg"])
    ms = 1 << (min(prompt_rows, 256).bit_length() - 1)
    nbytes = ops = 0.0
    for K, N in accountant_sites(cfg):
        T = min(K, 1024)
        for L, r in ((_pad(ms, ROWS), rw), (_pad(min(N, 256), COLS), rn)):
            b, o = k1_launch(1, T, L, r)
            nbytes += b
            ops += o
    return nbytes, ops


def lm_matmul_params(cfg: dict) -> float:
    """Parameters of every product of a token's forward (the layers' and
    the head's)."""
    return float(core.reference(cfg).matmul_params(cfg))
