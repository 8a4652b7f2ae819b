"""Plain counter pass over one edge's bus words: the reference of K1 and
of K3's counters.

Frozen copy of ``src/repro_torch/kernels/power_counters/ref.py``
(``fused_counters_ref`` and its scans), with the row layout of
``kernels/power_counters/spec.py`` (``CounterSpec.rows``) and the masks
of ``core/bits.py`` and ``core/zvg.py::is_zero``, as of this benchmark's
first version. :func:`counters` walks the lanes in blocks, so a stream
of millions of lanes fits in memory; every counter is per lane, and the
per-cycle zero count is summed over the blocks.
"""
from __future__ import annotations

import torch

MANT_MASK = 0x007F
NOT_SIGN = 0x7FFF
WORD_BITS = 16


def rows(bic_variants: tuple, zvg: bool) -> tuple[str, ...]:
    """Row names of one pass, in storage order."""
    names = ["raw", "mant_raw", "zeros"]
    if zvg:
        names += ["zvg", "mant_zvg", "iszero"]
    for v in bic_variants:
        names += [f"bic/{seg_key(v)}/data", f"bic/{seg_key(v)}/inv"]
    if zvg:
        for v in bic_variants:
            names += [f"bic_zvg/{seg_key(v)}/data", f"bic_zvg/{seg_key(v)}/inv"]
    return tuple(names)


def seg_key(segments) -> str:
    return "+".join(f"{int(s) & 0xFFFF:04x}" for s in segments)


def unique_segments(bic_variants: tuple) -> tuple[int, ...]:
    return tuple(dict.fromkeys(s for v in bic_variants for s in v))


def popcount(u: torch.Tensor) -> torch.Tensor:
    u = u.to(torch.int32) & 0xFFFF
    u = u - ((u >> 1) & 0x5555)
    u = (u & 0x3333) + ((u >> 2) & 0x3333)
    u = (u + (u >> 4)) & 0x0F0F
    return (u + (u >> 8)) & 0x1F


def segment_width(mask: int) -> int:
    return bin(int(mask) & 0xFFFF).count("1")


def _compose(f, g):
    f0, f1 = f
    g0, g1 = g
    return (f0 & g1) | (~f0 & g0), (f1 & g1) | (~f1 & g0)


def _scan(f0, f1):
    T = f0.shape[-2]
    off = 1
    while off < T:
        g0, g1 = _compose((f0[..., :-off, :], f1[..., :-off, :]),
                          (f0[..., off:, :], f1[..., off:, :]))
        f0 = torch.cat([f0[..., :off, :], g0], dim=-2)
        f1 = torch.cat([f1[..., :off, :], g1], dim=-2)
        off *= 2
    return f0, f1


def _delayed(x, first):
    return torch.cat([first, x[..., :-1, :]], dim=-2)


def _sum_t(v):
    return v.sum(dim=-2, dtype=torch.int32)


def _bic_rows(xo, raw_sum, bic_variants):
    segs = unique_segments(bic_variants)
    if not segs:
        return []
    d = {m: popcount(xo & m) for m in segs}
    f0 = torch.zeros_like(xo)
    f1 = torch.zeros_like(xo)
    for si, m in enumerate(segs):
        w = segment_width(m)
        f0 |= (d[m] * 2 > w).to(torch.int32) << si
        f1 |= (d[m] * 2 < w).to(torch.int32) << si
    inv, _ = _scan(f0, f1)
    flip_pack = inv ^ _delayed(inv, torch.zeros_like(inv[..., :1, :]))
    dsum, fsum = {}, {}
    for si, m in enumerate(segs):
        flip = (flip_pack >> si) & 1
        dsum[m] = _sum_t(flip * (segment_width(m) - 2 * d[m]))
        fsum[m] = _sum_t(flip)
    out = []
    for v in bic_variants:
        data = raw_sum
        for m in v:
            data = data + dsum[m]
        inv_tog = fsum[v[0]]
        for m in v[1:]:
            inv_tog = inv_tog + fsum[m]
        out += [data, inv_tog]
    return out


def _pass(x: torch.Tensor, bic_variants: tuple, zvg: bool):
    x = x.to(torch.int32) & 0xFFFF
    T = x.shape[-2]
    zero_row = torch.zeros_like(x[..., :1, :])
    z = (x & NOT_SIGN) == 0
    xo = x ^ _delayed(x, zero_row)
    raw = _sum_t(popcount(xo))
    out = [raw, _sum_t(popcount(xo & MANT_MASK)), _sum_t(z)]
    if zvg:
        t = torch.arange(T, dtype=torch.int64, device=x.device)[:, None]
        packed = torch.where(z, -1, (t << 16) | x.to(torch.int64))
        latest = torch.cummax(packed, dim=-2).values
        held = torch.where(latest >= 0, latest & 0xFFFF, 0).to(torch.int32)
        ho = held ^ _delayed(held, zero_row)
        hraw = _sum_t(popcount(ho))
        z_prev = _delayed(z, torch.zeros_like(z[..., :1, :]))
        out += [hraw, _sum_t(popcount(ho & MANT_MASK)), _sum_t(z ^ z_prev)]
    out += _bic_rows(xo, raw, bic_variants)
    if zvg:
        out += _bic_rows(ho, hraw, bic_variants)
    return torch.stack(out, dim=-2), z.sum(dim=-1, dtype=torch.int32)


def counters(x: torch.Tensor, bic_variants: tuple, zvg: bool,
             block_words: int = 1 << 26):
    """Per-lane counters ``int32[(B,) n_rows, L]`` and per-cycle zero
    words ``int32[(B,) T]`` of words ``[(B,) T, L]``, the bus starting at
    zero; lanes in blocks of about ``block_words`` words."""
    T, L = x.shape[-2:]
    step = max(1, min(L, block_words // max(T, 1)))
    parts, zeros = [], None
    for lo in range(0, L, step):
        c, z = _pass(x[..., lo:lo + step], bic_variants, zvg)
        parts.append(c)
        zeros = z if zeros is None else zeros + z
    return torch.cat(parts, dim=-1), zeros
