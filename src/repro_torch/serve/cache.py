"""Slot-based decode-state manager for continuous batching.

One set of per-layer decode states (``lm.make_decode_state`` with batch
``max_slots``: KV caches, rings, latent caches, recurrent states) lives
on the device for the engine's lifetime; a *slot* is one batch row of
every layer's states. Admission copies a prefilled batch-1 state into
the slot's row in place; retirement returns the slot to the free list.
A dead row is harmless: decode steps write junk at its position 0 (or
into its recurrent state), and nothing reads the row before the next
admission overwrites all of it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.runtime import sharding as rsh
from repro_torch.runtime import spmd


class SlotCache:
    """Fixed-capacity slot allocator over one shared decode state. Keeps,
    per slot, whether it is live, the next cache write position (the
    tokens held so far) and the token the next decode step embeds, in
    host-side numpy arrays."""

    def __init__(self, cfg: ArchConfig, max_slots: int, cache_len: int,
                 dtype: torch.dtype, device, mesh=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1: {max_slots}")
        self.cfg = cfg
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.device = torch.device(device)
        self.states = lm.make_decode_state(cfg, max_slots, cache_len, dtype,
                                           self.device)
        self.mesh = mesh
        self.shardings = None
        if mesh is not None:
            self.shardings = rsh.cache_shardings(mesh, self.states)
            self.states = rsh.device_put(self.states, self.shardings)
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
        for st, st1 in zip(self.states, states1):
            _install(st, st1, slot)
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
        return _batch_inputs(self.mesh, (
            torch.from_numpy(self.tokens[:, None]).to(self.device),
            torch.from_numpy(self.positions[:, None]).to(self.device)))


def _batch_inputs(mesh, inputs: tuple) -> tuple:
    """Decode inputs as they are, or distributed by ``batch_shardings``
    on a mesh (the batch dim over the data axes)."""
    if mesh is None:
        return inputs
    return rsh.device_put(inputs, rsh.batch_shardings(mesh, inputs))


def _install(state, state1, slot: int) -> None:
    """Copy a batch-1 decode state (a tensor or a nested tuple of them:
    KV caches, a ring with its slots, a latent cache, recurrent states)
    into row ``slot`` of the slot cache's state, in place (on a mesh,
    into the rank that holds the row)."""
    if isinstance(state, tuple):
        for s, s1 in zip(state, state1):
            _install(s, s1, slot)
    elif spmd.is_dist(state):
        spmd.index_write(state, (torch.tensor([slot], device=state.device),),
                         state1)
    else:
        state[slot].copy_(state1[0])
