"""CounterSpec: the static row layout of one fused counter pass.

One operand edge of the systolic array is a ``[T, L]`` word stream; the
fused pass walks it ONCE and emits every counter the design menu can ask
for, as rows of a dense ``int32[n_rows, L]`` per-lane table. The spec is
the contract shared by the CUDA kernel, the plain PyTorch version and
the public wrapper: it fixes which rows exist and in which order.

Rows (in order):

* ``raw`` / ``mant_raw``          -- unencoded full-bus / mantissa-field
  transition counts.
* ``zeros``                       -- zero-word count per lane.
* ``zvg`` / ``mant_zvg`` / ``iszero``  (``zvg=True`` only) -- transitions
  of the zero-held register sequence, its mantissa field, and the 1-bit
  is-zero line toggles.
* ``bic/<key>/data`` + ``bic/<key>/inv`` per BIC segment variant -- data
  toggles of the encoded bus and the invert-line toggles, separately.
* ``bic_zvg/<key>/data`` + ``bic_zvg/<key>/inv`` (``zvg=True`` only) --
  the same variants encoded over the zero-held stream.
* ``ones/00`` .. ``ones/15``      (``hist=True`` only) -- per-bit-position
  ones counts.

Beside the table every pass returns ``rowzeros``: the per-cycle zero-word
count ``int32[T]``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.bic import seg_key

#: bit width of the modelled bus words
WORD_BITS = 16


@dataclasses.dataclass(frozen=True)
class CounterSpec:
    """Static description of one fused counter pass (hashable).

    ``bic_variants`` is a tuple of segment-mask tuples -- one entry per
    BIC menu variant, each a tuple of disjoint masks (e.g. mant+exp is
    ``(0x007F, 0x7F80)``). ``zvg`` adds the zero-held / is-zero rows and
    the BIC-over-held variants; ``hist`` adds the 16 ones-count rows.
    """
    bic_variants: tuple[tuple[int, ...], ...] = ()
    zvg: bool = False
    hist: bool = False

    def __post_init__(self):
        norm = tuple(tuple(int(s) & 0xFFFF for s in v)
                     for v in self.bic_variants)
        for v in norm:
            if not v or any(s == 0 for s in v):
                raise ValueError(f"empty segment mask in variant {v}")
            union = 0
            for s in v:
                if union & s:
                    raise ValueError(f"overlapping segment masks in {v}")
                union |= s
        if len(set(norm)) != len(norm):
            raise ValueError(f"duplicate BIC variants {norm}")
        object.__setattr__(self, "bic_variants", norm)
        if len(self.unique_segments) > 31:
            raise ValueError(
                f"{len(self.unique_segments)} unique segments exceed the "
                f"31 bit lanes of the kernel's packed invert state")

    @property
    def rows(self) -> tuple[str, ...]:
        """Row names of the counter table, in storage order."""
        names = ["raw", "mant_raw", "zeros"]
        if self.zvg:
            names += ["zvg", "mant_zvg", "iszero"]
        for v in self.bic_variants:
            k = seg_key(v)
            names += [f"bic/{k}/data", f"bic/{k}/inv"]
        if self.zvg:
            for v in self.bic_variants:
                k = seg_key(v)
                names += [f"bic_zvg/{k}/data", f"bic_zvg/{k}/inv"]
        if self.hist:
            names += [f"ones/{b:02d}" for b in range(WORD_BITS)]
        return tuple(names)

    @property
    def n_rows(self) -> int:
        return len(self.rows)

    @property
    def unique_segments(self) -> tuple[int, ...]:
        """Distinct segment masks across all variants, in first-appearance
        order. A segment's invert recurrence depends only on the stream
        and its own mask, so variants share segment recurrences, and all
        of them ride bit lanes of one packed ``int32`` state."""
        return tuple(dict.fromkeys(s for v in self.bic_variants for s in v))

    @property
    def n_bic_states(self) -> int:
        """Carried packed invert-line words: one per encoded stream
        (raw always; held too when ``zvg``), zero without variants."""
        if not self.unique_segments:
            return 0
        return 2 if self.zvg else 1
