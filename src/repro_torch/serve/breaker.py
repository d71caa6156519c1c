"""Circuit breakers for the sort service (counterpart of
repro.serve.breaker; DESIGN.md Sec. 8).

One CircuitBreaker guards one bucket of the batched engine (one cache
key family). The three-state machine:

  closed     healthy; failures are counted, `threshold` consecutive
             failures trip the breaker.
  open       the batched path for this bucket is suspected broken (a
             kernel fault at one shape, say). Requests bypass it onto the
             degraded per-request path until `cooldown_s` elapses.
  half_open  cooldown expired; the next request probes the batched path.
             Success closes the breaker, failure re-opens it.

BreakerBoard aggregates the per-bucket breakers into the service health
that /healthz reports:

  ok         every breaker closed.
  degraded   at least one breaker open or half-open, but the degraded
             path is serving.
  tripped    at least one open breaker AND the degraded path itself is
             failing: the service cannot make progress for that bucket.

Clocks are injectable (`now`), so tests step time without sleeping.
"""
from __future__ import annotations

import threading
import time


class CircuitBreaker:
    def __init__(self, *, threshold: int = 3, cooldown_s: float = 30.0,
                 now=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._now = now
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: float | None = None
        self._probing = False
        self.trips = 0
        self.resets = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._now() - self._opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        """May the next request take the guarded (batched) path?"""
        with self._lock:
            st = self._state_locked()
            if st == "closed":
                return True
            if st == "half_open" and not self._probing:
                self._probing = True  # exactly one probe per cooldown
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._opened_at is not None:
                self.resets += 1
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._opened_at is not None:
                # a failed probe: re-open, restart the cooldown clock
                self._opened_at = self._now()
            elif self._failures >= self.threshold:
                self.trips += 1
                self._opened_at = self._now()

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state_locked(),
                    "failures": self._failures,
                    "trips": self.trips, "resets": self.resets}


class BreakerBoard:
    """Per-bucket breakers and the degraded-path health they feed to
    /healthz."""

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 30.0,
                 now=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._now = now
        self._lock = threading.Lock()
        self._breakers: dict = {}
        self._degraded_failing: set = set()

    def breaker(self, key) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(threshold=self.threshold,
                                    cooldown_s=self.cooldown_s, now=self._now)
                self._breakers[key] = br
            return br

    def record_degraded(self, key, ok: bool) -> None:
        """The outcome of a degraded-path (per-request) attempt."""
        with self._lock:
            if ok:
                self._degraded_failing.discard(key)
            else:
                self._degraded_failing.add(key)

    def health(self) -> str:
        with self._lock:
            open_keys = [k for k, b in self._breakers.items()
                         if b.state != "closed"]
            if not open_keys:
                return "ok"
            if any(k in self._degraded_failing for k in open_keys):
                return "tripped"
            return "degraded"

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "breakers": {str(k): b.snapshot()
                             for k, b in self._breakers.items()},
                "degraded_failing": sorted(str(k)
                                           for k in self._degraded_failing),
            }

    def full_snapshot(self) -> dict:
        snap = self.snapshot()
        snap["health"] = self.health()
        return snap
