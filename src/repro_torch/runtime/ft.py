"""Fault tolerance of the serving layer: straggler detection and a
supervised executor (counterpart of repro.runtime.ft, :32-137).

StepTimer keeps an EWMA of step wall time and flags stragglers (steps
slower than `threshold` x the EWMA). The serving layer
(repro_torch.serve.metrics) runs it over batch dispatch times, so a slow
batch (a cold start, a noisy neighbour on the host) raises the straggler
signal.

SupervisedExecutor is a one-worker thread pool under restart supervision:
the sort service runs every batch on it, and rebuilds it when a batch
poisons the worker.

The reference's third class, TrainSupervisor, wraps a train loop in
checkpoint and restart; it needs the checkpoint stack and belongs to the
model stack's port (ROADMAP queue 1 item 4), so it is not here.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import statistics
import threading


@dataclasses.dataclass
class StepTimer:
    """EWMA straggler detector over step wall times.

    A one-sample seed (warmup=1) has a blind spot: if the FIRST step is
    the slow one, it becomes the baseline and every healthy step after it
    looks fast. `warmup=k` withholds judgment for the first k steps and
    seeds the EWMA from their median, which one aberrant sample among the
    first k cannot move. `prior` seeds the EWMA explicitly (from a
    previous run's snapshot, say) and skips the warmup.
    """

    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 1
    prior: float | None = None
    ewma: float = 0.0
    stragglers: int = 0
    steps: int = 0
    _warm: list = dataclasses.field(default_factory=list, repr=False)

    def __post_init__(self):
        if self.prior is not None and self.ewma == 0.0:
            self.ewma = float(self.prior)

    def record(self, dt: float) -> bool:
        """Returns True if this step was a straggler."""
        self.steps += 1
        if self.ewma == 0.0:
            self._warm.append(dt)
            if len(self._warm) < max(1, self.warmup):
                return False
            self.ewma = statistics.median(self._warm)
            self._warm.clear()
            return False
        slow = dt > self.threshold * self.ewma
        self.stragglers += int(slow)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow

    def snapshot(self) -> dict:
        """The counters as a plain, JSON-safe dict."""
        return {"steps": self.steps, "ewma_s": self.ewma,
                "stragglers": self.stragglers, "threshold": self.threshold}

    def reset(self) -> None:
        self.ewma = float(self.prior) if self.prior is not None else 0.0
        self.stragglers = 0
        self.steps = 0
        self._warm.clear()


class SupervisedExecutor:
    """A single-worker ThreadPoolExecutor under restart supervision.

    A thread pool routes every exception a task raises into the task's
    future, so no task can kill its worker. What this class is for is the
    other direction: the consumer of those futures sees a fault that
    poisons the worker itself (repro_torch.runtime.chaos.ExecutorDeath
    stands in for a wedged device runtime or a dead host thread) and calls
    `report_death()`. The supervisor then tears the pool down
    (`cancel_futures=True`: a dead worker cannot drain its queue; pending
    tasks surface as CancelledError for the submitter to retry) and builds
    a fresh one, at most `max_restarts` times.
    """

    def __init__(self, *, max_restarts: int = 8,
                 thread_name_prefix: str = "supervised"):
        self.max_restarts = max_restarts
        self.restarts = 0
        self._prefix = thread_name_prefix
        self._lock = threading.Lock()
        self._pool = self._build()

    def _build(self) -> concurrent.futures.ThreadPoolExecutor:
        return concurrent.futures.ThreadPoolExecutor(
            max_workers=1,
            thread_name_prefix=f"{self._prefix}-{self.restarts}")

    def submit(self, fn, /, *args, **kwargs):
        with self._lock:
            return self._pool.submit(fn, *args, **kwargs)

    def report_death(self) -> int:
        """Replace the poisoned pool with a fresh one. Returns the restart
        ordinal; raises RuntimeError once the restart budget is spent."""
        with self._lock:
            self.restarts += 1
            if self.restarts > self.max_restarts:
                raise RuntimeError(
                    f"executor exceeded max_restarts={self.max_restarts}")
            old, self._pool = self._pool, None
            old.shutdown(wait=False, cancel_futures=True)
            self._pool = self._build()
            return self.restarts

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            self._pool.shutdown(wait=wait, cancel_futures=not wait)

    def snapshot(self) -> dict:
        return {"restarts": self.restarts,
                "max_restarts": self.max_restarts}
