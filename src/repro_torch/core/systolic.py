"""Output-stationary systolic-array streaming model.

Models the paper's 16x16 output-stationary SA computing ``A @ B`` with
``A: [M, K]`` inputs entering from the West and ``B: [K, N]`` weights from
the North. Matrices larger than the array run in (R x C) tiles; the K
(reduction) dimension streams through the array continuously. Every
register on a stream's path sees the same value sequence (time-shifted by
the skew), so total pipeline register toggles = (per-stream transitions)
x (path length): one counter pass per edge gives the exact activity.

The counters run where the operands live (the Hopper kernel for CUDA
tensors); their lane sums come to the host in one copy per edge, and the
menu and facts are float32 0-d tensors on the CPU (``[B]`` for a batch of
problems), priced there by :mod:`repro_torch.design`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.runtime import spans

from . import bic
from . import precision as prec


@dataclasses.dataclass(frozen=True)
class SAGeometry:
    """Systolic array geometry (rows x cols of PEs). Non-square shapes
    are first-class: rows/cols set the per-edge lane counts, padding,
    fill/drain cycles and unload depth independently."""
    rows: int = 16
    cols: int = 16

    def __post_init__(self):
        object.__setattr__(self, "rows", int(self.rows))
        object.__setattr__(self, "cols", int(self.cols))
        if self.rows < 1 or self.cols < 1:
            raise ValueError(
                f"SAGeometry needs rows >= 1 and cols >= 1, got "
                f"{self.rows}x{self.cols}")


PAPER_SA = SAGeometry(16, 16)
MXU_SA = SAGeometry(128, 128)

#: canonical menu-key suffix for a BIC segment tuple
seg_key = bic.seg_key


def _f32(v) -> torch.Tensor:
    """A Python number as a float32 0-d CPU tensor."""
    return torch.tensor(v, dtype=torch.float32)


def _fused_sub_mul(a, b, c) -> torch.Tensor:
    """``a - b*c`` rounded once to float32, as a fused multiply-add does
    (the float64 product of two float32 values is exact)."""
    return (a.double() - b.double() * c.double()).float()


def _pad_to(x: torch.Tensor, mult: int, dim: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _host_sums(lanes: list[torch.Tensor]) -> list[torch.Tensor]:
    """Exact integer sums over the last dim, brought to the host in one
    copy and rounded once to float32 (the JAX package's float32 sums of
    the same integers are exact below 2**24, and so equal)."""
    with spans.span("sa.lane_sums"):
        sums = torch.stack([v.sum(dim=-1, dtype=torch.int64)
                            for v in lanes])
        return list(sums.cpu().to(torch.float32))


def menu_lane_sums(rows: dict, prefix: str,
                   bic_variants: tuple[tuple[int, ...], ...],
                   with_zvg: bool) -> dict:
    """Sum one edge's per-lane counter rows to the float32 menu scalars:
    raw and mantissa transitions, one BIC count per variant (encoded data
    + invert-line toggles) and, with ``with_zvg``, the zero-held variants
    of all of these plus the is-zero line toggles."""
    lanes = {f"{prefix}_raw": rows["raw"],
             f"{prefix}_mant_raw": rows["mant_raw"]}
    if with_zvg:
        lanes[f"{prefix}_zvg"] = rows["zvg"]
        lanes[f"{prefix}_mant_zvg"] = rows["mant_zvg"]
        lanes[f"{prefix}_iszero"] = rows["iszero"]
    for segs in bic_variants:
        k = seg_key(segs)
        lanes[f"{prefix}_bic/{k}"] = (rows[f"bic/{k}/data"]
                                      + rows[f"bic/{k}/inv"])
        if with_zvg:
            lanes[f"{prefix}_bic_zvg/{k}"] = (rows[f"bic_zvg/{k}/data"]
                                             + rows[f"bic_zvg/{k}/inv"])
    return dict(zip(lanes, _host_sums(list(lanes.values()))))


def _edge_menu(bits: torch.Tensor, prefix: str,
               bic_variants: tuple[tuple[int, ...], ...],
               with_zvg: bool, backend: str | None):
    """Coding menu of one edge's ``[(B,) T, lanes]`` stream: ONE fused
    counter pass, then :func:`menu_lane_sums`. Returns ``(menu, per-cycle
    zero counts int32[(B,) T])``."""
    from repro_torch.kernels import power_counters as pc

    spec = pc.CounterSpec(bic_variants=bic_variants, zvg=with_zvg)
    with spans.span("sa.counters"):
        rows = pc.edge_counters(bits, spec, backend=backend)
    menu = menu_lane_sums(rows, prefix, bic_variants, with_zvg)
    return menu, rows["rowzeros"]


def stream_facts(geom: SAGeometry, M: int, K: int, N: int,
                 az_rows: torch.Tensor, nz_rows: torch.Tensor) -> dict:
    """Coding-independent facts of one tiled ``[M,K] x [K,N]`` matmul.

    ``az_rows`` / ``nz_rows`` are the per-cycle zero-word counts of the
    padded West and North streams (``int32[(B,) K]``).
    """
    R, C = geom.rows, geom.cols
    Mp, Np = M + (-M) % R, N + (-N) % C
    Tm, Tn = Mp // R, Np // C
    # zero input / weight lane-cycles, and MAC slots where BOTH operands
    # are zero (the inclusion-exclusion term when both edges gate)
    zeros, zeros_n, overlap = _host_sums(
        [az_rows, nz_rows, az_rows.to(torch.int64) * nz_rows])

    # XLA compiles the JAX package's jitted twin of these lines with the
    # division by the constant Mp*K as a product with its float32
    # reciprocal, and with a - b*c as one fused multiply-add: so does this
    inv_words = 1.0 / (_f32(Mp) * K)
    pe_slots = _f32(Mp) * Np * K                  # total MAC slots
    zero_fraction = zeros * inv_words
    # mean input-active fraction
    active_frac = _fused_sub_mul(_f32(1.0), zeros, inv_words)
    # acc register only toggles when the product is non-zero
    nonzero_slots = _fused_sub_mul(pe_slots, _f32(Np), zeros)

    fill = R + C - 2
    cycles = _f32(Tm) * Tn * (K + fill)
    unload_trav = _f32(Tm) * Tn * C * R * (R + 1) / 2.0     # 32b result shifts

    return {
        "M": _f32(M), "K": _f32(K), "N": _f32(N),
        "Mp": _f32(Mp), "Np": _f32(Np), "Tm": _f32(Tm), "Tn": _f32(Tn),
        "rows": _f32(R), "cols": _f32(C),
        "cycles": cycles,
        "pe_slots": pe_slots,
        "nonzero_slots": nonzero_slots,
        "active_frac": active_frac,
        "w_zeros": zeros,
        "n_zeros": zeros_n,
        "gated_overlap": overlap,
        "zero_fraction": zero_fraction,
        "unload_reg_traversals": unload_trav,
        "west_words": _f32(Tn) * Mp * K,    # West-edge words (zdet checks)
        "north_words": _f32(Tm) * Np * K,   # North-edge words (BIC encodes)
    }


def edge_streams(A: torch.Tensor, Bm: torch.Tensor,
                 geom: SAGeometry = PAPER_SA, precision: str = "bf16"):
    """The two edge streams of ``A [(B,) M, K] @ Bm [(B,) K, N]``: West
    words ``[(B,) K, M']`` and North words ``[(B,) K, N']``, contiguous,
    with M and N padded to the array's rows and cols by zero words (every
    format embeds zero as ``0x0000``). On the card the words are
    ``uint16``, so the counter kernel reads 2 bytes per word; on the CPU
    they stay ``int32`` for the plain version's arithmetic."""
    R, C = geom.rows, geom.cols
    # quantize BEFORE padding (the int8 absmax scale must see only real
    # data); bf16 words are exactly bits.to_bits
    nb = A.dim() - 2
    a_bits = _pad_to(prec.quantize_bits(A, precision, nb), R, -2)
    b_bits = _pad_to(prec.quantize_bits(Bm, precision, nb), C, -1)
    a_bits = a_bits.transpose(-1, -2)
    if A.is_cuda:
        return _as_uint16(a_bits), _as_uint16(b_bits)
    return a_bits.contiguous(), b_bits.contiguous()


def _as_uint16(words: torch.Tensor) -> torch.Tensor:
    """Contiguous ``uint16`` copy of ``int32`` words in 0..65535."""
    out = torch.empty(words.shape, dtype=torch.uint16, device=words.device)
    return out.copy_(words)


def sa_design_report(A: torch.Tensor, Bm: torch.Tensor,
                     geom: SAGeometry = PAPER_SA,
                     west_bic: tuple[tuple[int, ...], ...] = (),
                     north_bic: tuple[tuple[int, ...], ...] = (
                         bic.MANTISSA_ONLY,),
                     west_zvg: bool = True,
                     north_zvg: bool = False,
                     backend: str | None = None,
                     precision: str = "bf16") -> dict:
    """Coding-agnostic stream counters for one tiled matmul on the SA.

    One fused counter pass per operand edge computes a *menu* -- raw /
    BIC(segment-variant) / zero-gated / BIC-over-gated transition counts
    of the West (input) and North (weight) streams -- plus the
    coding-independent facts. Any number of
    :class:`repro_torch.design.DesignPoint`\\ s sharing ``geom`` are then
    priced from this one report.

    Args:
      A:  ``[M, K]`` inputs (West edge), or ``[B, M, K]`` for B
        independent problems (one counter launch per edge for the batch).
      Bm: ``[K, N]`` weights (North edge), or ``[B, K, N]``.
      geom: array geometry (determines padding, so also the stream lanes).
      west_bic / north_bic: BIC segment variants to tabulate per edge.
      west_zvg / north_zvg: tabulate the zero-gated menu for the edge.
      backend: counter backend (see
        :mod:`repro_torch.kernels.power_counters.ops`).
      precision: operand format, ``"bf16"`` or an 8-bit format of
        :mod:`repro_torch.core.precision` (segments in its embedded layout).

    Returns a flat dict of float32 CPU tensors (0-d, or ``[B]`` where a
    value depends on the problem).
    """
    if A.dim() != Bm.dim() or A.dim() not in (2, 3):
        raise ValueError(f"operands must be [M,K] x [K,N] or batched "
                         f"[B,M,K] x [B,K,N], got {tuple(A.shape)} x "
                         f"{tuple(Bm.shape)}")
    M, K = A.shape[-2:]
    K2, N = Bm.shape[-2:]
    if K != K2 or A.shape[:-2] != Bm.shape[:-2]:
        raise ValueError(
            f"shape mismatch {tuple(A.shape)} x {tuple(Bm.shape)}")
    with spans.span("sa.edge_streams"):
        a_bits, b_bits = edge_streams(A, Bm, geom, precision)
    out, az_rows = _edge_menu(a_bits, "w", tuple(west_bic), west_zvg, backend)
    n_menu, nz_rows = _edge_menu(b_bits, "n", tuple(north_bic), north_zvg,
                                 backend)
    out.update(n_menu)
    with spans.span("sa.facts"):
        out.update(stream_facts(geom, M, K, N, az_rows, nz_rows))
    return out


def sa_stream_report(A: torch.Tensor, Bm: torch.Tensor,
                     geom: SAGeometry = PAPER_SA,
                     bic_segments: Sequence[int] = bic.MANTISSA_ONLY,
                     zvg_enabled: bool = True,
                     backend: str | None = None) -> dict:
    """Legacy twin-design counters: ``_base`` (conventional SA) and
    ``_prop`` (BIC on weights + optional ZVG on inputs) fields, assembled
    from :func:`sa_design_report`."""
    R, C = geom.rows, geom.cols
    segs = tuple(int(s) for s in bic_segments)
    menu = sa_design_report(A, Bm, geom, west_bic=(), north_bic=(segs,),
                            west_zvg=True, north_zvg=False, backend=backend)

    tran_a_raw = menu["w_raw"]
    tran_a_zvg = menu["w_zvg"]
    tran_a_mant_raw = menu["w_mant_raw"]
    tran_a_mant_zvg = menu["w_mant_zvg"]
    iszero_tog = menu["w_iszero"]
    zeros = menu["w_zeros"]
    tran_b_raw = menu["n_raw"]
    tran_b_mant = menu["n_mant_raw"]
    tran_b_bic = menu[f"n_bic/{seg_key(segs)}"]
    Mp, Np = menu["Mp"], menu["Np"]
    Tm, Tn = menu["Tm"], menu["Tn"]
    active_frac = menu["active_frac"]

    gated_slots = Np * zeros if zvg_enabled else _f32(0.0)

    # pipeline register/wire toggles
    h_base = Tn * C * tran_a_raw
    h_prop = Tn * C * (tran_a_zvg + iszero_tog) if zvg_enabled else h_base
    v_base = Tm * R * tran_b_raw
    v_prop = Tm * R * tran_b_bic

    # multiplier input toggles; the b-side is masked by the input-active
    # fraction in both designs (a zero input zeroes every partial product)
    mult_a_base = Np * tran_a_raw
    mult_a_prop = Np * tran_a_zvg if zvg_enabled else mult_a_base
    mult_a_mant_base = Np * tran_a_mant_raw
    mult_a_mant_prop = (Np * tran_a_mant_zvg if zvg_enabled
                        else mult_a_mant_base)
    mult_b_base = active_frac * Mp * tran_b_raw
    mult_b_prop = mult_b_base
    mult_b_mant = active_frac * Mp * tran_b_mant

    return {
        "M": menu["M"], "K": menu["K"], "N": menu["N"],
        "Mp": Mp, "Np": Np, "Tm": Tm, "Tn": Tn,
        "rows": _f32(R), "cols": _f32(C),
        "cycles": menu["cycles"],
        "pe_slots": menu["pe_slots"],
        "gated_slots": gated_slots,
        "nonzero_slots": menu["nonzero_slots"],
        "zero_fraction": menu["zero_fraction"],
        "h_reg_toggles_base": h_base, "h_reg_toggles_prop": h_prop,
        "v_reg_toggles_base": v_base, "v_reg_toggles_prop": v_prop,
        "mult_a_toggles_base": mult_a_base, "mult_a_toggles_prop": mult_a_prop,
        "mult_b_toggles_base": mult_b_base, "mult_b_toggles_prop": mult_b_prop,
        "mult_a_mant_toggles_base": mult_a_mant_base,
        "mult_a_mant_toggles_prop": mult_a_mant_prop,
        "mult_b_mant_toggles": mult_b_mant,
        "unload_reg_traversals": menu["unload_reg_traversals"],
        "zdet_words": menu["west_words"],
        "enc_words": menu["north_words"],
    }


def streaming_activity_reduction(report: dict) -> torch.Tensor:
    """Paper §I headline: relative reduction of data-streaming switching
    activity (horizontal + vertical pipeline toggles) vs the unencoded SA."""
    base = report["h_reg_toggles_base"] + report["v_reg_toggles_base"]
    prop = report["h_reg_toggles_prop"] + report["v_reg_toggles_prop"]
    return 1.0 - prop / torch.clamp_min(base, 1.0)


def sa_matmul_reference(A: torch.Tensor, Bm: torch.Tensor) -> torch.Tensor:
    """Numerical ground truth of what the modelled SA computes: the
    float32 product (full float32 on the card unless the caller lets
    TF32 into ``torch.matmul``)."""
    return torch.matmul(A.to(torch.float32), Bm.to(torch.float32))
