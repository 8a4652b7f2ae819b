"""Fault tolerance and straggler instrumentation for the trainer, the
port's own copy of the JAX package's ``repro.runtime.fault``:

* :class:`StepTimer` -- per-step wall time on the host clock, flagging
  stragglers (over ``straggler_factor`` x the running median). On the
  card it synchronises the device before it reads the clock, so a step's
  time is its work's, not its launches'.
* :class:`Preemption` -- a SIGTERM handler that sets a flag; the train
  loop checkpoints and exits at the next step boundary.
* :func:`run_with_restarts` -- restarts a training function that
  raises; the function resumes from its latest checkpoint.
"""
from __future__ import annotations

import collections
import logging
import signal
import statistics
import time

import torch

log = logging.getLogger("repro_torch.fault")


class StepTimer:
    def __init__(self, window: int = 50, straggler_factor: float = 2.0,
                 device=None):
        self.times = collections.deque(maxlen=window)
        self.factor = straggler_factor
        self.straggler_steps: list[int] = []
        self._t0 = None
        self._cuda = device is not None and torch.device(device).type == "cuda"

    def _sync(self):
        if self._cuda:
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        if len(self.times) >= 5:
            med = statistics.median(self.times)
            if dt > self.factor * med:
                self.straggler_steps.append(step)
                log.warning("straggler step %d: %.3fs vs median %.3fs",
                            step, dt, med)
        self.times.append(dt)
        return dt

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


class Preemption:
    """Flag-based graceful preemption (SIGTERM -> checkpoint -> exit)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._signals = signals
        self._old = {}

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; will checkpoint "
                    "and exit at the next step boundary", signum)
        self.requested = True


def run_with_restarts(train_fn, max_restarts: int = 3,
                      retry_delay: float = 0.0):
    """Run ``train_fn()``; on an exception, run it again (it must resume
    from its checkpointer), up to ``max_restarts`` times. Returns its
    result."""
    attempt = 0
    while True:
        try:
            return train_fn()
        except KeyboardInterrupt:
            raise
        except Exception as e:                      # noqa: BLE001
            attempt += 1
            if attempt > max_restarts:
                log.error("giving up after %d restarts", max_restarts)
                raise
            log.warning("training crashed (%s); restart %d/%d",
                        e, attempt, max_restarts)
            if retry_delay:
                time.sleep(retry_delay)
