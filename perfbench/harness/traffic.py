"""The one generator of serving traffic, driven by a traffic file.

A traffic file (``traffic/<name>.json``) gives:

* ``clients``: closed-loop clients; each sends its next request as soon
  as the previous one has finished;
* ``prompt`` and ``output``: token counts, ``{"dist": "loguniform", "lo",
  "hi"}`` (``"fixed"`` takes ``lo``);
* ``prefixes`` (optional): ``{"count", "length"}`` shared system prompts;
  a request's prompt is one of them followed by a unique suffix whose
  length ``prompt`` gives;
* ``pool``: how many lengths are drawn for each distribution;
* ``strata`` (optional): ``k`` cuts each pool into ``k`` strata of
  consecutive quantiles, and every ``k`` consecutive requests take one
  length from each, in an order of the seed's.

Every seed gets the same set of lengths -- the ``pool`` quantiles of
each distribution -- in another order, and its own token ids: the seed
changes which requests come when, not how much work they are. A window
that sends only a few dozen long requests needs ``strata`` for that to
hold within the window too. Token ids are uniform over the vocabulary.
"""
from __future__ import annotations

import math

import torch


def lengths(spec: dict, n: int) -> list[int]:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of ``spec``."""
    lo, hi = int(spec["lo"]), int(spec.get("hi", spec["lo"]))
    if spec.get("dist", "fixed") == "fixed" or lo == hi:
        return [lo] * n
    if spec["dist"] != "loguniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    a, b = math.log(lo), math.log(hi + 1)
    return [min(hi, int(math.exp(a + (b - a) * (i + 0.5) / n)))
            for i in range(n)]


class Traffic:
    """Requests of one traffic mix for one seed, each ``(prompt, max_new,
    prefix)`` with ``prefix`` the shared system prompt's index or
    ``None``."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.vocab = int(vocab)
        self.gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
        n = int(spec.get("pool", 256))
        k = int(spec.get("strata", 1))
        self.prompts = self._ordered(lengths(spec["prompt"], n), k)
        self.outputs = self._ordered(lengths(spec["output"], n), k)
        self.prefixes = []
        pre = spec.get("prefixes")
        if pre:
            self.prefixes = [self._tokens(int(pre["length"]))
                             for _ in range(int(pre["count"]))]
            order = [i % len(self.prefixes) for i in range(n)]
            self.prefix_of = self._shuffled(order)
        self.i = 0

    @property
    def clients(self) -> int:
        return int(self.spec["clients"])

    def _shuffled(self, xs: list) -> list:
        perm = torch.randperm(len(xs), generator=self.gen).tolist()
        return [xs[j] for j in perm]

    def _ordered(self, xs: list, k: int) -> list:
        """``xs`` (ascending) in the seed's order; with ``k`` strata each
        block of ``k`` holds one entry of every stratum."""
        if k <= 1:
            return self._shuffled(xs)
        if len(xs) % k:
            raise ValueError(f"pool {len(xs)} is not a multiple of "
                             f"strata {k}")
        per = len(xs) // k
        strata = [self._shuffled(xs[i * per:(i + 1) * per])
                  for i in range(k)]
        return [x for j in range(per)
                for x in self._shuffled([s[j] for s in strata])]

    def _tokens(self, n: int) -> list[int]:
        return torch.randint(self.vocab, (n,), generator=self.gen).tolist()

    def next(self):
        j = self.i % len(self.prompts)
        self.i += 1
        body = self._tokens(self.prompts[j])
        pre = None
        if self.prefixes:
            pre = self.prefix_of[j]
            body = self.prefixes[pre] + body
        return body, self.outputs[j], pre

    def prefill_lengths(self) -> list[int]:
        """Every prompt length the mix can send, shortest first."""
        extra = len(self.prefixes[0]) if self.prefixes else 0
        return sorted({p + extra for p in self.prompts})
