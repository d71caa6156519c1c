"""The dynamic batcher: shape buckets and batch-size-or-deadline flushing
(counterpart of repro.serve.batcher).

Queueing policy only: no torch, no dispatch. `SortService` owns one
`DynamicBatcher` per event loop and hands it admitted requests; the
batcher groups them by `repro_torch.sort.bucket_key` (length, dtype,
kind, spec fingerprint: the key family of the shard-program cache, so one
bucket is one program family) and fires a flush callback when a bucket

  * reaches `max_batch` requests ("size", the throughput-optimal flush),
  * has waited `max_delay_s` since its first pending request ("deadline",
    the latency bound for a trickle of traffic), or
  * the service drains it ("drain", shutdown).

The engine underneath is `repro_torch.sort.sort_batched`, whose cost per
batch is one pipeline with one collective per phase whatever B is, which
is why occupancy is worth chasing.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class Request:
    """One admitted sort request, queued until its bucket flushes.

    deadline is absolute `loop.time()` (None = no deadline); expired
    requests are dropped from the batch at dispatch, resolved with
    DeadlineExceeded, and never poison the surviving requests.
    """
    kind: str                  # "sort" | "argsort" | "sort_kv" |
    #                            "semisort" | "top_k"
    x: Any                     # 1-D NumPy key array
    values: Any                # sort_kv payload, else None
    spec: Any                  # SortSpec (argsort/sort_kv: already stable)
    key: tuple                 # repro_torch.sort.bucket_key(...)
    future: asyncio.Future
    t_submit: float            # loop.time() at admission
    deadline: float | None = None
    param: Any = None          # kind-specific scalar (top_k: the k)


class DynamicBatcher:
    """Per-bucket pending queues with size-or-deadline flushing.

    Single-threaded: every method runs on the owning event loop (the
    service sees to it). `flush_cb(key, requests, reason)` is called
    synchronously from the loop; the service wraps it in a task.
    """

    def __init__(self, *, max_batch: int, max_delay_s: float,
                 flush_cb: Callable[[tuple, list, str], None]):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.flush_cb = flush_cb
        self._pending: dict[tuple, list[Request]] = {}
        self._timers: dict[tuple, asyncio.TimerHandle] = {}

    @property
    def depth(self) -> int:
        """Requests waiting in buckets (not yet handed to a flush)."""
        return sum(len(v) for v in self._pending.values())

    def add(self, req: Request) -> None:
        pend = self._pending.setdefault(req.key, [])
        pend.append(req)
        if len(pend) >= self.max_batch:
            self._fire(req.key, "size")
        elif len(pend) == 1:
            loop = asyncio.get_running_loop()
            self._timers[req.key] = loop.call_later(
                self.max_delay_s, self._fire, req.key, "deadline")

    def _fire(self, key: tuple, reason: str) -> None:
        timer = self._timers.pop(key, None)
        if timer is not None:
            timer.cancel()
        reqs = self._pending.pop(key, None)
        if reqs:
            self.flush_cb(key, reqs, reason)

    def flush_all(self, reason: str = "drain") -> None:
        for key in list(self._pending):
            self._fire(key, reason)
