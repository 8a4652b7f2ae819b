"""Configuration of the paged serving mode.

Attach a :class:`PagingConfig` to ``ServeConfig.paging`` and
``ServeEngine`` builds a :class:`~repro_torch.serve.paging.engine.
PagedServeEngine`: requests share one pool of fixed-size KV pages through
per-row page tables, so device memory is committed page by page as
sequences grow instead of one worst-case region per slot.

Scheduling classes (:class:`SchedClass`) belong to the paged mode:
admission picks the highest-priority class with queued work, breaks
priority ties by deficit round-robin over the weights, and page pressure
preempts the lowest-priority, latest-admitted request.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SchedClass:
    """One scheduling class.

    priority: higher admits first and is preempted last.
    weight: admission share among classes of equal priority (weights 3:1
      admit about 3 of one per 1 of the other under backlog).
    """
    name: str = "default"
    priority: int = 0
    weight: int = 1

    def __post_init__(self):
        if self.weight < 1:
            raise ValueError(f"weight must be >= 1: {self.weight}")


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """Knobs of the paged serving mode.

    page_size: KV positions per page; must divide ``cache_len``.
    num_pages: pool pages; page 0 is the reserved trash page, so
      ``num_pages - 1`` are allocatable. At equal device memory the slot
      engine holds ``max_slots * cache_len`` positions, the pool
      ``num_pages * page_size``.
    max_rows: decode batch width (requests decoding at once); it caps
      rows, not memory.
    prefill_chunk: > 0 streams prompts longer than this through admission
      in chunks of this many tokens, one chunk per engine step; 0
      prefills a whole prompt in one call, as the slot engine does.
    prefix_cache: share full prompt-prefix pages between requests through
      a refcounted trie (shared pages are read-only; a fork copies table
      entries, never pages).
    classes: scheduling classes; () is one default class (FIFO).
    """
    page_size: int = 16
    num_pages: int = 64
    max_rows: int = 8
    prefill_chunk: int = 0
    prefix_cache: bool = False
    classes: tuple[SchedClass, ...] = ()

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1: {self.page_size}")
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved trash "
                f"page): {self.num_pages}")
        if self.max_rows < 1:
            raise ValueError(f"max_rows must be >= 1: {self.max_rows}")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0: {self.prefill_chunk}")
