"""Slot-based KV-cache manager for continuous batching.

One set of per-layer decode states (``lm.make_decode_state`` with batch
``max_slots``) lives on the device for the engine's lifetime; a *slot* is
one batch row of every layer's caches. Admission copies a prefilled
batch-1 state into the slot's row in place; retirement returns the slot
to the free list. A dead row is harmless: decode steps write junk at its
position 0, and nothing reads the row before the next admission
overwrites all of it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig


class SlotCache:
    """Fixed-capacity slot allocator over one shared decode state. Keeps,
    per slot, whether it is live, the next cache write position (the
    tokens held so far) and the token the next decode step embeds, in
    host-side numpy arrays."""

    def __init__(self, cfg: ArchConfig, max_slots: int, cache_len: int,
                 dtype: torch.dtype, device):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1: {max_slots}")
        self.cfg = cfg
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.device = torch.device(device)
        self.states = lm.make_decode_state(cfg, max_slots, cache_len, dtype,
                                           self.device)
        self._free: list[int] = list(range(max_slots - 1, -1, -1))
        self.live = np.zeros(max_slots, bool)
        self.positions = np.zeros(max_slots, np.int64)
        self.tokens = np.zeros(max_slots, np.int64)
        self.allocations = 0           # total allocate() calls (reuse stat)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return self.max_slots - len(self._free)

    def live_slots(self) -> list[int]:
        return [i for i in range(self.max_slots) if self.live[i]]

    def allocate(self) -> int:
        """Pop the lowest free slot; follow with :meth:`write_prefill`."""
        if not self._free:
            raise RuntimeError("no free slot")
        slot = self._free.pop()
        self.live[slot] = True
        self.allocations += 1
        return slot

    def release(self, slot: int) -> None:
        if not self.live[slot]:
            raise RuntimeError(f"slot {slot} is not live")
        self.live[slot] = False
        self.positions[slot] = 0
        self.tokens[slot] = 0
        self._free.append(slot)
        self._free.sort(reverse=True)   # deterministic: lowest slot next

    def write_prefill(self, slot: int, states1: list, first_token: int,
                      prompt_len: int) -> None:
        """Install a prefilled request: the batch-1 ``states1`` (padded to
        ``cache_len``) into the slot's row, the position at
        ``prompt_len``, where the next decode writes ``first_token``."""
        if prompt_len >= self.cache_len:
            raise RuntimeError(
                f"prompt_len {prompt_len} >= cache_len {self.cache_len}")
        for (kc, vc), (k1, v1) in zip(self.states, states1):
            kc[slot].copy_(k1[0])
            vc[slot].copy_(v1[0])
        self.positions[slot] = prompt_len
        self.tokens[slot] = first_token

    def advance(self, slot: int, token: int) -> None:
        """After a decode step: the slot consumed its input token and
        will feed ``token`` next."""
        self.positions[slot] += 1
        self.tokens[slot] = token
        if self.positions[slot] > self.cache_len:
            raise RuntimeError(
                f"slot {slot} position {self.positions[slot]} overflowed "
                f"cache_len {self.cache_len}")

    def decode_inputs(self) -> tuple[torch.Tensor, ...]:
        """``(tokens [B, 1], positions [B, 1])`` for one shared decode
        step; dead rows feed token 0 at position 0."""
        return (torch.from_numpy(self.tokens[:, None]).to(self.device),
                torch.from_numpy(self.positions[:, None]).to(self.device))
