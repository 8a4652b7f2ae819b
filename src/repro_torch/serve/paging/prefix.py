"""Shared prompt prefixes over full KV pages: a refcounted trie.

Sharing is sound at page granularity for causal caches: the K/V at
position ``p`` depend only on tokens ``0..p``, so two prompts that agree
on their first ``n * page_size`` tokens give the same ``n`` pages, and
one physical copy can back both page tables. Partial pages are never
shared, and a request always keeps at least one unshared prompt token so
that its own prefill has a last position to take logits from.

Each node of the trie is a page-sized chunk of tokens and owns one pool
page. Its ``refs`` counts the requests reading it, and a parent's count
is at least its children's, so a node can be evicted exactly when it is a
leaf with no reader. Eviction is LRU among those and happens only under
page pressure.

Shared pages sit at the front of a request's page table and the model
never writes them (prefill fills the request's own pages, decode writes
past the prompt), so forking a prefix copies table entries, never pages.
"""
from __future__ import annotations


class _Node:
    __slots__ = ("chunk", "page", "refs", "last_use", "children", "parent")

    def __init__(self, chunk: tuple, page: int, parent):
        self.chunk = chunk
        self.page = page
        self.refs = 0
        self.last_use = 0
        self.children: dict[tuple, _Node] = {}
        self.parent = parent


class PrefixCache:
    """Trie of full prompt-prefix pages with transitive refcounts."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._root = _Node((), -1, None)   # sentinel, holds no page
        self._clock = 0                    # LRU tick
        self._by_page: dict[int, _Node] = {}
        self.lookups = 0
        self.hit_pages = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    def __len__(self) -> int:
        return len(self._by_page)

    def _chunks(self, tokens, max_pages: int):
        ps = self.page_size
        n = min(len(tokens) // ps, max_pages)
        return [tuple(tokens[i * ps:(i + 1) * ps]) for i in range(n)]

    def match(self, tokens, max_pages: int) -> list[int]:
        """The longest cached prefix of ``tokens`` (at most ``max_pages``
        pages), acquired: the chain's refcounts go up, pinning it against
        eviction. Returns its page ids in order; give them back with
        :meth:`release`."""
        self.lookups += 1
        self._clock += 1
        chain: list[_Node] = []
        node = self._root
        for chunk in self._chunks(tokens, max_pages):
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            chain.append(nxt)
            node = nxt
        for n in chain:
            n.refs += 1
            n.last_use = self._clock
        self.hit_pages += len(chain)
        return [n.page for n in chain]

    def release(self, pages: list[int]) -> None:
        """Drop one reference from each page of an acquired chain."""
        for p in pages:
            node = self._by_page[p]
            if node.refs <= 0:
                raise RuntimeError(f"refcount underflow on page {p}")
            node.refs -= 1

    def insert(self, tokens, held_pages: list[int],
               new_pages: list[int]) -> int:
        """Extend the cached chain of ``tokens`` past the caller's acquired
        ``held_pages`` with its prefill-written ``new_pages``, handing them
        to the cache.

        Stops at the first chunk another request registered meanwhile (its
        page differs; that page and the rest stay the caller's). Returns
        the number of pages absorbed; they are left acquired, so the caller
        releases its whole ``held + absorbed`` chain when it finishes."""
        self._clock += 1
        chunks = self._chunks(tokens, len(held_pages) + len(new_pages))
        node = self._root
        for i, p in enumerate(held_pages):
            node = node.children[chunks[i]]
            if node.page != p:
                raise RuntimeError(f"held page {p} does not match the "
                                   f"cached chain")
            node.last_use = self._clock
        absorbed = 0
        for chunk, page in zip(chunks[len(held_pages):], new_pages):
            if chunk in node.children:
                break
            nxt = _Node(chunk, page, node)
            node.children[chunk] = nxt
            self._by_page[page] = nxt
            self.inserted_pages += 1
            nxt.refs += 1
            nxt.last_use = self._clock
            node = nxt
            absorbed += 1
        return absorbed

    def pop_evictable(self) -> int:
        """Detach and return the page of the least recently used leaf that
        no request reads, or -1 when every cached page is pinned."""
        best = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.refs == 0 and (best is None or n.last_use < best.last_use):
                best = n
        if best is None:
            return -1
        best.parent.children.pop(best.chunk)
        self._by_page.pop(best.page)
        self.evicted_pages += 1
        return best.page
