"""Class-aware admission for the paged engine.

It keeps the FIFO scheduler's validation and retirement rules and adds:

* **strict priority across classes** -- admission considers only the
  highest-priority classes with queued work; under page pressure the
  lower classes' running requests are preempted first (see the engine);
* **deficit round-robin within a priority** -- each class of the tier
  holds a credit balance; a pick goes to the class with the most credit
  (declaration order breaks ties) and costs one credit; when every
  class of the tier is out of credit, each recharges by its weight.

A preempted request goes back to the FRONT of its class
(:meth:`ClassScheduler.requeue_front`), ahead of later arrivals.
"""
from __future__ import annotations

from collections import deque

from ..request import Request, RequestStatus
from ..scheduler import FIFOScheduler
from .config import SchedClass


class ClassScheduler(FIFOScheduler):
    """Priority classes and weighted DRR, FIFO within each class."""

    def __init__(self, cache_len: int, classes: tuple[SchedClass, ...] = (),
                 page_size: int = 0, usable_pages: int = 0):
        super().__init__(cache_len)
        if not classes:
            classes = (SchedClass(),)
        if len({c.name for c in classes}) != len(classes):
            raise ValueError("duplicate class names")
        self.classes: dict[str, SchedClass] = {c.name: c for c in classes}
        self.queues: dict[str, deque[Request]] = {
            c.name: deque() for c in classes}
        self.credits: dict[str, int] = {c.name: 0 for c in classes}
        self.page_size = page_size
        self.usable_pages = usable_pages

    def validate(self, req: Request) -> None:
        super().validate(req)
        if req.klass not in self.classes:
            raise ValueError(f"unknown scheduling class {req.klass!r}; "
                             f"registered: {sorted(self.classes)}")
        if self.page_size:
            # runnable alone: the worst-case footprint must fit the pool,
            # else page acquisition could wait with no victim to preempt
            footprint = req.prompt_len + req.max_new_tokens
            need = -(-footprint // self.page_size)
            if need > self.usable_pages:
                raise ValueError(
                    f"request needs {need} cache pages worst-case "
                    f"({footprint} positions / page_size {self.page_size}) "
                    f"but the pool has only {self.usable_pages} allocatable "
                    f"pages")

    def _enqueue(self, req: Request) -> None:
        self.queues[req.klass].append(req)

    def requeue_front(self, req: Request) -> None:
        """Put a preempted (or blocked) request ahead of its whole class."""
        req.status = RequestStatus.QUEUED
        self.queues[req.klass].appendleft(req)

    @property
    def n_pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def find(self, uid: int) -> Request | None:
        for q in self.queues.values():
            for req in q:
                if req.uid == uid:
                    return req
        return None

    def cancel(self, uid: int) -> bool:
        req = self.find(uid)
        if req is None:
            return False
        self.queues[req.klass].remove(req)
        req.status = RequestStatus.FINISHED
        req.finish_reason = "cancelled"
        return True

    def pop_admissible(self, n_free_slots: int) -> list[Request]:
        out: list[Request] = []
        while len(out) < n_free_slots:
            req = self._pick()
            if req is None:
                break
            out.append(req)
        return out

    def _pick(self) -> Request | None:
        ready = [name for name, q in self.queues.items() if q]
        if not ready:
            return None
        top = max(self.classes[name].priority for name in ready)
        tier = [name for name in ready if self.classes[name].priority == top]
        if all(self.credits[name] <= 0 for name in tier):
            for name in tier:
                self.credits[name] += self.classes[name].weight
        # max() keeps the first of equals: declaration order breaks ties
        name = max(tier, key=lambda n: self.credits[n])
        self.credits[name] -= 1
        return self.queues[name].popleft()
