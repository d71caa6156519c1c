"""Typed errors of the sort service (counterpart of repro.serve.errors).

Every way a request can fail before the sort itself runs has its own
exception type, so callers (and the HTTP front end's status mapping) can
tell admission pressure from a missed deadline from shutdown.
"""
from __future__ import annotations


class ServeError(RuntimeError):
    """Base class of every service-layer failure."""


class Overloaded(ServeError):
    """Admission control rejected the request: the queue holds
    `max_queue_depth` outstanding requests (which is also how a saturated
    `max_in_flight` batch limit shows: stalled dispatches keep their
    requests outstanding, so the queue fills and new arrivals bounce).

    HTTP mapping: 429.
    """

    def __init__(self, reason: str, *, queued: int = 0, in_flight: int = 0):
        super().__init__(
            f"service overloaded ({reason}): queued={queued} "
            f"in_flight_batches={in_flight}")
        self.reason = reason
        self.queued = queued
        self.in_flight = in_flight


class DeadlineExceeded(ServeError):
    """The request's deadline passed while it waited for a batch slot.
    Expired requests are dropped from their batch before dispatch; they
    never poison the remaining requests. HTTP mapping: 504."""


class ServiceClosed(ServeError):
    """The service is draining or closed; no new requests are admitted.
    HTTP mapping: 503."""
