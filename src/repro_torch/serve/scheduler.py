"""Admission and retirement policy for the serving engine.

FIFO with feasibility checks: a request is admissible when a slot is
free, and its whole worst-case footprint (prompt + max_new_tokens) must
fit the KV cache -- admission never over-commits, so a running request is
retired only by EOS or its own budget, never by eviction. Infeasible
requests are rejected at submit.

Retirement checks run after every decode step, in slot order:
  "eos"    -- the request's newest token is the engine's EOS id;
  "length" -- max_new_tokens generated;
  "cache"  -- the next write position would leave the cache (unreachable
              when admission validated the footprint).
"""
from __future__ import annotations

from collections import deque

from .request import Request, RequestStatus


class FIFOScheduler:
    """Order-preserving queue + the admit/retire policy."""

    def __init__(self, cache_len: int):
        self.cache_len = cache_len
        self.pending: deque[Request] = deque()
        self._next_uid = 0

    def validate(self, req: Request) -> None:
        """Raise ValueError on a request that could never run."""
        if req.prompt_len < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1: "
                             f"{req.max_new_tokens}")
        footprint = req.prompt_len + req.max_new_tokens
        if footprint > self.cache_len:
            raise ValueError(
                f"request needs {footprint} cache positions "
                f"({req.prompt_len} prompt + {req.max_new_tokens} new) but "
                f"cache_len is {self.cache_len}")

    def _enqueue(self, req: Request) -> None:
        self.pending.append(req)

    def submit(self, req: Request) -> Request:
        self.validate(req)
        req.uid = self._next_uid
        self._next_uid += 1
        req.status = RequestStatus.QUEUED
        self._enqueue(req)
        return req

    @property
    def n_pending(self) -> int:
        return len(self.pending)

    def find(self, uid: int) -> Request | None:
        """The queued request with this uid, if any."""
        for req in self.pending:
            if req.uid == uid:
                return req
        return None

    def cancel(self, uid: int) -> bool:
        """Drop a still-queued request (False when unknown or already
        admitted: running requests are not preempted)."""
        for req in self.pending:
            if req.uid == uid:
                self.pending.remove(req)
                req.status = RequestStatus.FINISHED
                req.finish_reason = "cancelled"
                return True
        return False

    def pop_admissible(self, n_free_slots: int) -> list[Request]:
        """Up to ``n_free_slots`` requests, strictly FIFO."""
        out = []
        while self.pending and len(out) < n_free_slots:
            out.append(self.pending.popleft())
        return out

    def retire_reason(self, req: Request, position: int,
                      eos_id: int | None) -> str:
        """'' while the request should keep decoding."""
        if (eos_id is not None and req.generated
                and req.generated[-1] == eos_id):
            return "eos"
        if len(req.generated) >= req.max_new_tokens:
            return "length"
        if position >= self.cache_len:
            return "cache"
        return ""
