"""Deterministic, restart-safe training data, as numpy batches laid out
as the JAX package's (``repro.data.pipeline``, bit for bit; the trainer
moves each batch to its device).

Two sources:

* :class:`SyntheticLM` -- seeded Zipfian token streams made per (step,
  host) with a copied half, so the loss can fall; stateless, so a run
  resumed at step N sees exactly the batches an uninterrupted run would.
* :class:`TokenFileSource` -- a memory-mapped token file sharded by
  host; its cursor is a function of (step, host), so it needs no
  checkpoint state either.

Batches are ``[global_batch // host_count, seq]``: each host makes only
its slice (``host_index`` of ``host_count``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 1234
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Zipfian token stream with enough structure for loss to fall:
    ``{"tokens"}``, ``{"embeds", "positions", "labels"}`` or
    ``{"codes"}`` by the config's input kind."""

    def __init__(self, cfg: ArchConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        ranks = np.arange(1, cfg.vocab + 1)
        p = 1.0 / ranks ** 1.1
        self.probs = p / p.sum()

    def batch(self, step: int) -> dict:
        d = self.data
        local = d.global_batch // d.host_count
        rng = np.random.default_rng(
            (d.seed * 1_000_003 + step) * 997 + d.host_index)
        if self.cfg.inputs == "codes":
            codes = rng.choice(self.cfg.vocab,
                               size=(local, self.cfg.codebooks, d.seq_len),
                               p=self.probs)
            return {"codes": codes.astype(np.int32)}
        toks = rng.choice(self.cfg.vocab, size=(local, d.seq_len),
                          p=self.probs)
        # copy structure: the second half repeats the first
        half = d.seq_len // 2
        toks[:, half:half * 2] = toks[:, :half]
        if self.cfg.inputs == "embeds":
            emb = rng.standard_normal(
                (local, d.seq_len, self.cfg.d_model)).astype(np.float32)
            pos = np.broadcast_to(np.arange(d.seq_len),
                                  (3, local, d.seq_len)).astype(np.int32)
            return {"embeds": emb * 0.02, "positions": pos,
                    "labels": toks.astype(np.int32)}
        return {"tokens": toks.astype(np.int32)}


class TokenFileSource:
    """A flat binary uint16/uint32 token file, host-sharded, with a
    stateless cursor."""

    def __init__(self, path: str, cfg: ArchConfig, data: DataConfig,
                 dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.cfg = cfg
        self.data = data

    def batch(self, step: int) -> dict:
        d = self.data
        local = d.global_batch // d.host_count
        span = d.seq_len + 1
        per_step = d.global_batch * span
        n_tokens = len(self.tokens)
        base = (step * per_step) % max(n_tokens - per_step, 1)
        start = base + d.host_index * local * span
        out = np.empty((local, d.seq_len), np.int32)
        for i in range(local):
            s = (start + i * span) % (n_tokens - span)
            out[i] = np.asarray(self.tokens[s:s + d.seq_len])
        return {"tokens": out % self.cfg.vocab}


def make_source(cfg: ArchConfig, data: DataConfig, path: str | None = None):
    """A :class:`TokenFileSource` over ``path``, else :class:`SyntheticLM`."""
    if path:
        return TokenFileSource(path, cfg, data)
    return SyntheticLM(cfg, data)
