"""Token sampling for the serving engine: greedy / temperature / top-k.

One batched function serves every co-batched request whatever its
parameters: temperature and top-k enter as ``[B]`` tensors. Greedy rows
(temperature 0) take ``argmax`` exactly, ties to the first index, as
``jnp.argmax``. Stochastic rows draw Gumbel noise from an explicit
``torch.Generator`` (the engine's, seeded from ``ServeConfig.seed``); the
port does not reproduce ``jax.random``'s draws, so only greedy tokens
compare across the two packages.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature 0 => greedy (argmax); > 0 => softmax sampling at that
    temperature. top_k 0 => no truncation; k > 0 keeps the logits at or
    above the k-th largest (ties at the threshold all kept)."""
    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0: {self.top_k}")


GREEDY = SamplingParams()


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One token per row of ``logits [B, V]`` (int64 ``[B]``). Every call
    draws ``[B, V]`` uniforms from ``gen`` whatever the rows ask for, so
    the generator advances the same way for any mix of requests."""
    v = logits.shape[-1]
    u = torch.rand(logits.shape, generator=gen, device=gen.device)
    u = u.to(logits.device).clamp_(min=torch.finfo(torch.float32).tiny)
    kth = top_k.clamp(1, v).long()
    thresh = logits.sort(dim=-1, descending=True).values.gather(
        -1, kth[:, None] - 1)
    truncate = (top_k > 0)[:, None]
    masked = torch.where(truncate & (logits < thresh), -torch.inf, logits)
    scaled = masked / temperature.clamp_min(1e-6)[:, None]
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)
