"""repro_torch.serve — an async sort service over the batched engine
(counterpart of repro.serve).

The serving layer the batched engine was built for: an asyncio request
queue that admits `sort`/`argsort`/`sort_kv`/`semisort`/`top_k`
requests, buckets them by shape, dtype and spec (the key family of
`repro_torch.sort.exec_cache`), flushes each bucket
on batch size or deadline, dispatches ONE batched launch per batch on the
spec's device, and resolves per-request futures in input order, with
admission control, per-request deadlines, graceful drain, a metrics
registry and a stdlib-only HTTP front end. DESIGN.md Sec. 7 describes
the lifecycle; Sec. 8 the self-healing layer (batch retry and bisection,
the supervised executor, per-bucket circuit breakers with a degraded
per-request path, and the ok | degraded | tripped health of /healthz).

    from repro_torch.serve import ServiceConfig, SortService
    from repro_torch.sort import SortSpec

    async with SortService(spec=SortSpec(exchange="allgather")) as svc:
        out = await svc.submit(keys)              # sorted NumPy array

Threaded callers (HTTP, benchmarks) use `ServiceRunner`; the front end is
`python -m repro_torch.serve.http`; `python -m repro_torch.serve.smoke`
runs the drills.
"""
import importlib

from repro_torch.serve.errors import (
    DeadlineExceeded, Overloaded, ServeError, ServiceClosed)

# Submodules are imported lazily (PEP 562), as the reference's are: the
# batcher, the breakers and the metrics need no torch.
_LAZY = {
    "DynamicBatcher": "repro_torch.serve.batcher",
    "Request": "repro_torch.serve.batcher",
    "BreakerBoard": "repro_torch.serve.breaker",
    "CircuitBreaker": "repro_torch.serve.breaker",
    "MetricsRegistry": "repro_torch.serve.metrics",
    "ServiceConfig": "repro_torch.serve.service",
    "ServiceRunner": "repro_torch.serve.service",
    "SortService": "repro_torch.serve.service",
}

__all__ = [
    "BreakerBoard", "CircuitBreaker", "DeadlineExceeded", "DynamicBatcher",
    "MetricsRegistry", "Overloaded", "Request", "ServeError",
    "ServiceClosed", "ServiceConfig", "ServiceRunner", "SortService",
]


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.serve' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(__all__)
