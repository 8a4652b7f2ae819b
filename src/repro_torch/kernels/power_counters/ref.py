"""Plain PyTorch version of the fused power-counter pass.

Bit-identical to the JAX reference's ``fused_counters_ref`` and to the
CUDA kernel. Both sequential recurrences become log-depth scans over T,
vectorised over lanes (and batch), so ResNet50's K = 4608 layers take
seconds, not minutes:

* the held (zero-gated) register is the word at the latest non-zero
  cycle so far: a ``cummax`` over ``t << 16 | word`` with zero cycles
  packed to -1;
* every segment's invert line is a composition of per-step boolean
  functions of the previous line, carried as packed ``(f(0), f(1))``
  words with one bit lane per unique segment; a Hillis-Steele scan of
  :func:`compose_packed` yields every cycle's lines at once. Within a
  segment of width ``w`` the encoded bus then toggles ``d`` bits where
  the line holds and ``w - d`` where it flips, so the encoded stream is
  never built.
"""
from __future__ import annotations

import torch

from repro_torch.core import bits as B
from repro_torch.core.zvg import is_zero

from .spec import WORD_BITS, CounterSpec


def compose_packed(f, g):
    """``h = g . f`` for step functions given as packed ``(f(0), f(1))``
    words: ``h(s) = f(s) ? g(1) : g(0)``, bitwise, so one composition
    serves every segment's bit lane at once."""
    f0, f1 = f
    g0, g1 = g
    return (f0 & g1) | (~f0 & g0), (f1 & g1) | (~f1 & g0)


def _inclusive_scan(f0, f1):
    """Hillis-Steele inclusive scan of :func:`compose_packed` along dim -2
    (cycles): entry ``t`` becomes ``f_t . ... . f_0``."""
    T = f0.shape[-2]
    off = 1
    while off < T:
        g0, g1 = compose_packed((f0[..., :-off, :], f1[..., :-off, :]),
                                (f0[..., off:, :], f1[..., off:, :]))
        f0 = torch.cat([f0[..., :off, :], g0], dim=-2)
        f1 = torch.cat([f1[..., :off, :], g1], dim=-2)
        off *= 2
    return f0, f1


def _delayed(x, first):
    """``x`` shifted one cycle later along dim -2, ``first`` in front."""
    return torch.cat([first, x[..., :-1, :]], dim=-2)


def _sum_t(v):
    return v.sum(dim=-2, dtype=torch.int32)


def _bic_rows(xo, raw_sum, spec: CounterSpec):
    """Data/inv toggle rows of every BIC variant of one stream, given its
    per-cycle XOR deltas ``xo`` (against the previous word, the bus
    starting at zero) and its summed full-bus toggles ``raw_sum``."""
    segs = spec.unique_segments
    if not segs:
        return []
    d = {m: B.popcount(xo & m) for m in segs}
    f0 = torch.zeros_like(xo)   # line after this step if it was low
    f1 = torch.zeros_like(xo)   # ... if it was high (ties clear both)
    for si, m in enumerate(segs):
        w = B.segment_width(m)
        f0 |= (d[m] * 2 > w).to(torch.int32) << si
        f1 |= (d[m] * 2 < w).to(torch.int32) << si
    inv, _ = _inclusive_scan(f0, f1)         # lines start low: h(0)
    flip_pack = inv ^ _delayed(inv, torch.zeros_like(inv[..., :1, :]))
    dsum, fsum = {}, {}
    for si, m in enumerate(segs):
        flip = (flip_pack >> si) & 1
        dsum[m] = _sum_t(flip * (B.segment_width(m) - 2 * d[m]))
        fsum[m] = _sum_t(flip)
    rows = []
    for v in spec.bic_variants:
        data = raw_sum
        for m in v:
            data = data + dsum[m]
        invtog = fsum[v[0]]
        for m in v[1:]:
            invtog = invtog + fsum[m]
        rows += [data, invtog]
    return rows


def fused_counters_ref(x: torch.Tensor, spec: CounterSpec):
    """Counter pass over words ``[T, L]`` (or ``[B, T, L]``).

    Returns ``(counts: int32[n_rows, L], rowzeros: int32[T])`` (with a
    leading ``B`` for batched input); the bus starts all-zero, so every
    counter includes the ``0 -> x[0]`` edge.
    """
    x = x.to(torch.int32) & 0xFFFF
    T = x.shape[-2]
    zero_row = torch.zeros_like(x[..., :1, :])
    z = is_zero(x)
    xo = x ^ _delayed(x, zero_row)
    raw = _sum_t(B.popcount(xo))
    rows = [raw, _sum_t(B.popcount(xo & B.MANT_MASK)), _sum_t(z)]
    if spec.zvg:
        t = torch.arange(T, dtype=torch.int64, device=x.device)[:, None]
        packed = torch.where(z, -1, (t << 16) | x.to(torch.int64))
        latest = torch.cummax(packed, dim=-2).values
        held = torch.where(latest >= 0, latest & 0xFFFF, 0).to(torch.int32)
        ho = held ^ _delayed(held, zero_row)
        hraw = _sum_t(B.popcount(ho))
        z_prev = _delayed(z, torch.zeros_like(z[..., :1, :]))
        rows += [hraw, _sum_t(B.popcount(ho & B.MANT_MASK)),
                 _sum_t(z ^ z_prev)]
    rows += _bic_rows(xo, raw, spec)
    if spec.zvg:
        rows += _bic_rows(ho, hraw, spec)
    if spec.hist:
        rows += [_sum_t((x >> bit) & 1) for bit in range(WORD_BITS)]
    counts = torch.stack(rows, dim=-2)
    return counts, z.sum(dim=-1, dtype=torch.int32)
