"""Fault tolerance: straggler detection, a supervised executor and the
train loop's restart supervisor (counterpart of repro.runtime.ft).

StepTimer keeps an EWMA of step wall time and flags stragglers (steps
slower than `threshold` x the EWMA). The serving layer
(repro_torch.serve.metrics) runs it over batch dispatch times, so a slow
batch (a cold start, a noisy neighbour on the host) raises the straggler
signal.

SupervisedExecutor is a one-worker thread pool under restart supervision:
the sort service runs every batch on it, and rebuilds it when a batch
poisons the worker.

TrainSupervisor wraps a train loop in checkpoint and restart: on any
step exception the loop restarts from the latest atomically committed
checkpoint (repro_torch.ckpt), at most `max_restarts` times.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import statistics
import threading
import time
from typing import Callable

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore, save
from repro_torch.sort.api import resolve_device


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


class TrainSupervisor:
    """Checkpoint/restart supervision of a train loop (the reference's
    TrainSupervisor, ft.py:139-196), restoring onto `device`.

    A step function may update the state in place, as the port's train
    step does (the reference donates its state instead). So after a step
    has run, `init_state` is no longer the initial state: a failure with
    no committed checkpoint to restore is raised, not restarted from it.
    A restart restores the checkpoint into `init_state`'s own tensors, so
    the device holds one copy of the state across restarts.
    """

    def __init__(self, ckpt_dir: str, *, save_every: int = 100,
                 max_restarts: int = 3, keep: int = 3, async_save: bool = True,
                 device="cuda"):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.keep = keep
        self.device = resolve_device(device)
        self.timer = StepTimer()
        self._ckpt = AsyncCheckpointer(ckpt_dir, keep=keep) if async_save \
            else None
        self.restarts = 0

    def _save(self, step, state, extra):
        if self._ckpt is not None:
            self._ckpt.save(step, state, extra)
        else:
            save(self.ckpt_dir, step, state, extra=extra, keep=self.keep)

    def resume_or_init(self, init_state):
        """Restore the latest checkpoint into init_state's tensors (in
        place), or return (0, init_state) for a cold start."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return 0, init_state
        state, extra = restore(self.ckpt_dir, step, init_state,
                               device=self.device)
        return extra.get("next_step", step), state

    def run(self, init_state, total_steps: int, step_fn: Callable,
            *, on_metrics: Callable | None = None):
        """step_fn(step, state) -> (state, metrics). Restarts on exception."""
        while True:
            start, state = self.resume_or_init(init_state)
            try:
                for step in range(start, total_steps):
                    t0 = time.monotonic()
                    state, metrics = step_fn(step, state)
                    slow = self.timer.record(time.monotonic() - t0)
                    if on_metrics:
                        on_metrics(step, metrics, slow)
                    if (step + 1) % self.save_every == 0 or \
                            step + 1 == total_steps:
                        self._save(step + 1, state,
                                   {"next_step": step + 1})
                if self._ckpt is not None:
                    self._ckpt.wait()
                return state
            except KeyboardInterrupt:
                raise
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                if self._ckpt is not None:
                    self._ckpt.wait()
                if latest_step(self.ckpt_dir) is None:
                    raise
                # fall through: restore from the latest good checkpoint

