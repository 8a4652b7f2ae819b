"""Request lifecycle for the serving engine.

A :class:`Request` is the unit of work: a prompt, a token budget,
sampling parameters, and -- once retired -- the generated tokens plus an
optional per-request streaming-power report. Lifecycle: QUEUED ->
RUNNING (admitted into a KV-cache slot or page-table row) -> FINISHED
(EOS, token budget, cache horizon, or cancelled). The paged engine may
send a RUNNING request back to QUEUED when it preempts it. The engine never
changes a request after retirement.
"""
from __future__ import annotations

import dataclasses
import enum

from .sampling import SamplingParams


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids (at least one; the
    engine does not tokenize), a decode budget ``max_new_tokens >= 1``,
    per-request ``sampling``, and the engine-assigned ``uid``."""
    prompt: list[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = SamplingParams()
    uid: int = -1
    klass: str = "default"         # scheduling class (the paged engine's;
                                   # the slot engine's FIFO ignores it)

    # ---- engine-owned state --------------------------------------------
    status: RequestStatus = RequestStatus.QUEUED
    slot: int = -1                 # KV-cache slot once admitted
    generated: list[int] = dataclasses.field(default_factory=list)
    finish_reason: str = ""        # "eos" | "length" | "cache" | "cancelled"
    submit_step: int = -1          # engine step counters: queueing delay
    start_step: int = -1           # is start_step - submit_step
    finish_step: int = -1
    preemptions: int = 0           # times evicted under page pressure and
                                   # re-queued (paged engine only)
    power: "object | None" = None  # RequestPowerReport when accounting is on

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.status is RequestStatus.FINISHED
