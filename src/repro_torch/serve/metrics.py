"""Serving metrics registry (counterpart of repro.serve.metrics;
DESIGN.md Sec. 7.3).

One thread-safe registry per `SortService` accumulates what the operator
of a sort service watches:

  * per-bucket counters: requests, batches, batch occupancy, flush
    reasons (size/deadline/drain), queue wait, the shard-program cache's
    hit and miss deltas attributed to the bucket, and a bounded latency
    reservoir from which p50/p99 are computed at snapshot time;
  * global counters: admissions, typed rejections, expired and cancelled
    requests, served results;
  * a batch-time EWMA (`repro_torch.runtime.ft.StepTimer`, seeded from
    the median of the first `straggler_warmup` batches, so a slow first
    batch cannot poison the baseline) that flags straggler batches;
  * self-healing counters (DESIGN.md Sec. 8): batch retries, bisections,
    executor restarts, degraded-path requests and the engine's overflow
    recovery totals, plus a pluggable `health` provider (the breaker
    board) merged into the snapshot;
  * the process-wide cache counters
    (`repro_torch.sort.driver.exec_cache.stats()`), read at snapshot time.

`snapshot()` returns one JSON-safe nested dict (what `GET /metrics`
serves); `reset()` zeroes the registry for before/after measurements:
the load tests warm the cache, reset, then check steady-state rates.
"""
from __future__ import annotations

import threading
from collections import deque

from repro_torch.runtime.ft import StepTimer


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile of an unsorted sample list (q in [0, 1])."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    rank = min(len(ordered) - 1, max(0, int(q * len(ordered) + 0.5) - 1))
    return ordered[rank]


class _BucketMetrics:
    """Counters for one batch bucket (one `repro_torch.sort.bucket_key`)."""

    def __init__(self, window: int):
        self.requests = 0
        self.batches = 0
        self.occupancy_sum = 0
        self.flush_reasons: dict = {}
        self.queue_wait_s_sum = 0.0
        self.queue_wait_s_max = 0.0
        self.cache_hits = 0
        self.cache_misses = 0
        self.expired = 0
        self.errors = 0
        self.retries = 0
        self.bisections = 0
        self.degraded = 0
        self.verify_failures = 0
        self.verify_fallbacks = 0
        self.latency_s = deque(maxlen=window)
        self.imbalance = deque(maxlen=window)

    def as_dict(self) -> dict:
        lat = list(self.latency_s)
        batches = max(self.batches, 1)
        cache_total = self.cache_hits + self.cache_misses
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_occupancy": self.occupancy_sum / batches,
            "flush_reasons": dict(self.flush_reasons),
            "queue_wait_ms": {
                "mean": 1e3 * self.queue_wait_s_sum / max(self.requests, 1),
                "max": 1e3 * self.queue_wait_s_max,
            },
            "cache": {
                "hits": self.cache_hits,
                "misses": self.cache_misses,
                "hit_rate": (self.cache_hits / cache_total
                             if cache_total else 0.0),
            },
            "expired": self.expired,
            "errors": self.errors,
            "retries": self.retries,
            "bisections": self.bisections,
            "degraded": self.degraded,
            "verify_failures": self.verify_failures,
            "verify_fallbacks": self.verify_fallbacks,
            "imbalance": {
                "p50": percentile(list(self.imbalance), 0.50),
                "p99": percentile(list(self.imbalance), 0.99),
                "max": max(self.imbalance, default=0.0),
                "samples": len(self.imbalance),
            },
            "latency_ms": {
                "p50": 1e3 * percentile(lat, 0.50),
                "p99": 1e3 * percentile(lat, 0.99),
                "mean": 1e3 * (sum(lat) / len(lat)) if lat else 0.0,
                "samples": len(lat),
            },
        }


class MetricsRegistry:
    """Thread-safe serving metrics: observed from the asyncio loop thread
    and the dispatch executor thread alike, snapshotted from anywhere."""

    def __init__(self, *, window: int = 2048, straggler_threshold: float = 3.0,
                 straggler_warmup: int = 3, cache_stats=None, health=None):
        self._lock = threading.Lock()
        self._window = window
        self._straggler_threshold = straggler_threshold
        self._straggler_warmup = straggler_warmup
        self._cache_stats = cache_stats   # callable -> dict, or None
        self._health = health             # callable -> dict, or None
        self._reset_locked()

    def _reset_locked(self):
        self._buckets: dict = {}
        self.admitted = 0
        self.served = 0
        self.rejected: dict = {}
        self.expired = 0
        self.cancelled = 0
        self.errors = 0
        self.batches = 0
        self.batch_retries = 0
        self.bisections = 0
        self.executor_restarts = 0
        self.degraded_requests = 0
        self.degraded_errors = 0
        self.overflow_retries = 0
        self.overflow_recovered = 0
        self.verify_failures = 0
        self.verify_retries = 0
        self.verify_fallbacks = 0
        self.verify_failed_requests = 0
        self.batch_timer = StepTimer(threshold=self._straggler_threshold,
                                     warmup=self._straggler_warmup)

    def _bucket(self, key) -> _BucketMetrics:
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = _BucketMetrics(self._window)
        return b

    # -- observations ------------------------------------------------------

    def observe_admit(self, key) -> None:
        with self._lock:
            self.admitted += 1

    def observe_reject(self, reason: str) -> None:
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

    def observe_expired(self, key) -> None:
        with self._lock:
            self.expired += 1
            self._bucket(key).expired += 1

    def observe_cancelled(self, key) -> None:
        with self._lock:
            self.cancelled += 1

    def observe_batch(self, key, *, size: int, reason: str, queue_waits_s,
                      compute_s: float, cache_delta=None) -> bool:
        """Record one dispatched batch; returns the straggler flag."""
        with self._lock:
            self.batches += 1
            b = self._bucket(key)
            b.batches += 1
            b.requests += size
            b.occupancy_sum += size
            b.flush_reasons[reason] = b.flush_reasons.get(reason, 0) + 1
            for w in queue_waits_s:
                b.queue_wait_s_sum += w
                b.queue_wait_s_max = max(b.queue_wait_s_max, w)
            if cache_delta:
                b.cache_hits += cache_delta.get("hits", 0)
                b.cache_misses += cache_delta.get("misses", 0)
            return self.batch_timer.record(compute_s)

    def observe_batch_retry(self, key) -> None:
        with self._lock:
            self.batch_retries += 1
            self._bucket(key).retries += 1

    def observe_bisection(self, key) -> None:
        with self._lock:
            self.bisections += 1
            self._bucket(key).bisections += 1

    def observe_executor_restart(self) -> None:
        with self._lock:
            self.executor_restarts += 1

    def observe_degraded(self, key, *, ok: bool = True) -> None:
        with self._lock:
            self.degraded_requests += 1
            self._bucket(key).degraded += 1
            if not ok:
                self.degraded_errors += 1

    def observe_recovery(self, key, recovery) -> None:
        """The engine's recovery record (repro_torch.sort.RecoveryStats):
        the overflow-retry trail, the verification policy's failed-audit
        and fallback counters, and the achieved partition imbalance (the
        paper's (1+eps) quantity, sampled into a per-bucket reservoir for
        the /metrics quantiles)."""
        if recovery is None:
            return
        with self._lock:
            b = self._bucket(key)
            if recovery.attempts > 1:
                self.overflow_retries += recovery.attempts - 1
                self.overflow_recovered += recovery.recovered_overflow
            if recovery.verify_failures:
                self.verify_failures += recovery.verify_failures
                self.verify_retries += recovery.verify_retries
                b.verify_failures += recovery.verify_failures
            if recovery.verify_fallback:
                self.verify_fallbacks += 1
                b.verify_fallbacks += 1
            if recovery.achieved_imbalance is not None:
                b.imbalance.append(float(recovery.achieved_imbalance))

    def observe_verify_failure(self, key, rows: int = 1) -> None:
        """Requests whose audit failed for good (served as typed
        VerificationErrors after the policy gave up). The audit counters
        themselves arrive through `observe_recovery` (the raised output's
        RecoveryStats carries them), so only the per-request total is
        counted here."""
        with self._lock:
            self.verify_failed_requests += rows

    def observe_result(self, key, latency_s: float, *, ok: bool = True) -> None:
        with self._lock:
            b = self._bucket(key)
            b.latency_s.append(latency_s)
            if ok:
                self.served += 1
            else:
                self.errors += 1
                b.errors += 1

    # -- readout -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "admitted": self.admitted,
                "served": self.served,
                "rejected": dict(self.rejected),
                "expired": self.expired,
                "cancelled": self.cancelled,
                "errors": self.errors,
                "batches": self.batches,
                "batch_retries": self.batch_retries,
                "bisections": self.bisections,
                "executor_restarts": self.executor_restarts,
                "degraded_requests": self.degraded_requests,
                "degraded_errors": self.degraded_errors,
                "overflow_retries": self.overflow_retries,
                "overflow_recovered": self.overflow_recovered,
                "verify_failures": self.verify_failures,
                "verify_retries": self.verify_retries,
                "verify_fallbacks": self.verify_fallbacks,
                "verify_failed_requests": self.verify_failed_requests,
                "batch_timer": self.batch_timer.snapshot(),
                "buckets": {repr(k): b.as_dict()
                            for k, b in self._buckets.items()},
            }
        if self._cache_stats is not None:
            snap["exec_cache"] = self._cache_stats()
        if self._health is not None:
            snap["health"] = self._health()
        return snap

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()
