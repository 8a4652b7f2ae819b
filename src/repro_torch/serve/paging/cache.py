"""Block-paged KV cache: one page pool and per-row page tables.

The pool is ``lm.make_decode_state`` with ``batch = num_pages`` and
``cache_len = page_size``: per layer ``(k_pool, v_pool)``, each ``[P,
page_size, Hkv, D]``, the slot cache's layout with pages where the slots
were. A row's logical position ``p`` lives at ``(table[p // page_size],
p % page_size)``; the decode step takes the tables as a ``[B, MP]`` input
and the model writes and reads through them (see
``models.transformer._page_targets`` and the paged decode attention).

Page 0 is the reserved trash page: never allocated, the target of dead
rows' decode writes and of padded chunk tails. A table entry 0 therefore
also means "unallocated": what reads through it lands at positions the
length masks.

Rows are the decode batch. Rows and pages are both handed out lowest
first, as the slot cache hands out slots, so the paged and slot engines
assign the same rows and draw the same random numbers. A row is
``reserved`` while a chunked prefill streams into its pages and becomes
``live`` (decoded) when the prompt is complete.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig

TRASH = 0          # reserved pool page: write redirect target, never owned


class PagedKVCache:
    """Page pool, row allocator and per-row page tables.

    Per row the host keeps: live/reserved flags, the next cache write
    position, the pending input token, the page table (``0`` = trash =
    unallocated), and how many leading table entries are shared (held
    through the prefix cache: read-only, released to it, never freed).
    """

    def __init__(self, cfg: ArchConfig, max_rows: int, cache_len: int,
                 page_size: int, num_pages: int, dtype: torch.dtype, device):
        if max_rows < 1:
            raise ValueError(f"max_rows must be >= 1: {max_rows}")
        if cache_len % page_size:
            raise ValueError(
                f"page_size {page_size} must divide cache_len {cache_len}")
        self.cfg = cfg
        self.max_rows = max_rows
        self.cache_len = cache_len
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_row = cache_len // page_size
        self.device = torch.device(device)
        self.states = lm.make_decode_state(cfg, num_pages, page_size, dtype,
                                           self.device)
        self._free_rows: list[int] = list(range(max_rows - 1, -1, -1))
        self._free_pages: list[int] = list(range(num_pages - 1, 0, -1))
        self.live = np.zeros(max_rows, bool)        # decoding
        self.reserved = np.zeros(max_rows, bool)    # prefill in flight
        self.positions = np.zeros(max_rows, np.int64)
        self.tokens = np.zeros(max_rows, np.int64)
        self.tables = np.full((max_rows, self.max_pages_per_row), TRASH,
                              np.int32)
        self.n_shared = np.zeros(max_rows, np.int32)  # leading shared pages
        self.allocations = 0         # row allocations (reuse stat)
        self.page_allocations = 0    # page allocations (churn stat)

    # ------------------------------------------------------------- rows
    @property
    def n_free(self) -> int:
        return len(self._free_rows)

    @property
    def n_live(self) -> int:
        """Rows in use, decoding or mid-prefill (drives ``run()``)."""
        return self.max_rows - len(self._free_rows)

    def live_slots(self) -> list[int]:
        """Rows in the shared decode step, in row order."""
        return [i for i in range(self.max_rows) if self.live[i]]

    def allocate(self) -> int:
        """Pop the lowest free row (reserved until activate/release)."""
        if not self._free_rows:
            raise RuntimeError("no free row")
        row = self._free_rows.pop()
        self.reserved[row] = True
        self.allocations += 1
        return row

    def release(self, row: int) -> tuple[list[int], list[int]]:
        """Free a row; returns ``(owned_pages, shared_pages)`` in table
        order: the caller frees the owned ones (:meth:`free_pages`) and
        hands the shared ones back to the prefix cache."""
        if not (self.live[row] or self.reserved[row]):
            raise RuntimeError(f"row {row} is not in use")
        ns = int(self.n_shared[row])
        held = [int(p) for p in self.tables[row] if p != TRASH]
        owned, shared = held[ns:], held[:ns]
        self.live[row] = False
        self.reserved[row] = False
        self.positions[row] = 0
        self.tokens[row] = 0
        self.tables[row] = TRASH
        self.n_shared[row] = 0
        self._free_rows.append(row)
        self._free_rows.sort(reverse=True)
        return owned, shared

    # ------------------------------------------------------------ pages
    @property
    def n_free_pages(self) -> int:
        return len(self._free_pages)

    def allocate_pages(self, n: int) -> list[int]:
        """Pop ``n`` free pages, lowest first; all or nothing."""
        if n > len(self._free_pages):
            raise RuntimeError(f"need {n} pages, {len(self._free_pages)} "
                               f"free")
        out = [self._free_pages.pop() for _ in range(n)]
        self.page_allocations += len(out)
        return out

    def free_pages(self, pages: list[int]) -> None:
        for p in pages:
            if p == TRASH:
                raise RuntimeError("freeing the trash page")
            if p in self._free_pages:
                raise RuntimeError(f"double free of page {p}")
            self._free_pages.append(p)
        self._free_pages.sort(reverse=True)

    def set_table(self, row: int, pages: list[int], n_shared: int) -> None:
        """Install a row's page table: ``pages[:n_shared]`` are prefix
        cache pages (read-only), the rest owned."""
        self.tables[row] = TRASH
        self.tables[row, :len(pages)] = pages
        self.n_shared[row] = n_shared

    def grow_table(self, row: int, page: int) -> None:
        """Append one owned page to a row's table (decode growth)."""
        idx = int(np.argmax(self.tables[row] == TRASH))
        if self.tables[row, idx] != TRASH:
            raise RuntimeError(f"row {row} table is full")
        self.tables[row, idx] = page

    def next_write_unbacked(self, row: int) -> bool:
        """True when the row's next decode write position has no page."""
        pi = int(self.positions[row]) // self.page_size
        return (pi < self.max_pages_per_row
                and self.tables[row, pi] == TRASH)

    # ------------------------------------------------------------ state
    def scatter_prefill(self, row: int, states1: list,
                        n_pages_used: int) -> None:
        """Copy a dense batch-1 prefill state (``cache_len`` wide) into
        the first ``n_pages_used`` pages of the row's table, in place."""
        ps = self.page_size
        n = n_pages_used * ps
        idx = torch.from_numpy(self.tables[row, :n_pages_used]).to(
            self.device).long()
        for (kp, vp), (k1, v1) in zip(self.states, states1):
            kp[idx] = k1[0, :n].reshape((n_pages_used, ps) + kp.shape[2:])
            vp[idx] = v1[0, :n].reshape((n_pages_used, ps) + vp.shape[2:])

    def activate(self, row: int, first_token: int, prompt_len: int) -> None:
        """Prefill complete: the row joins the shared decode batch at
        position ``prompt_len``, feeding ``first_token``."""
        if prompt_len >= self.cache_len:
            raise RuntimeError(
                f"prompt_len {prompt_len} >= cache_len {self.cache_len}")
        self.reserved[row] = False
        self.live[row] = True
        self.positions[row] = prompt_len
        self.tokens[row] = first_token

    def advance(self, row: int, token: int) -> None:
        self.positions[row] += 1
        self.tokens[row] = token
        if self.positions[row] > self.cache_len:
            raise RuntimeError(
                f"row {row} position {self.positions[row]} overflowed "
                f"cache_len {self.cache_len}")

    def decode_inputs(self) -> tuple[torch.Tensor, ...]:
        """``(tokens [B, 1], positions [B, 1], pages [B, MP])`` for one
        shared decode step. Rows that are not live feed token 0 at
        position 0 through an all-trash table, so they read junk and write
        the trash page: a row still mid-prefill keeps its pages out of the
        step. (The JAX package hands such a row its own table, and the
        step writes junk at position 0 of its first page.)"""
        tables = np.where(self.live[:, None], self.tables, TRASH)
        return (torch.from_numpy(self.tokens[:, None]).to(self.device),
                torch.from_numpy(self.positions[:, None]).to(self.device),
                torch.from_numpy(tables.astype(np.int32)).to(self.device))
