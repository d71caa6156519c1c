"""SortService: `repro_torch.sort` as an online, dynamically batched
service (counterpart of repro.serve.service).

The batched engine underneath sorts B requests in one pipeline with one
collective per phase whatever B is, and `repro_torch.sort.exec_cache`
counts each batch's launch under the reference's cache keys.
This module lets concurrent callers reach that throughput: an asyncio
front door admits `sort`/`argsort`/`sort_kv`/`semisort`/`top_k`
requests, buckets them by `repro_torch.sort.bucket_key`, flushes each
bucket on batch size or deadline (repro_torch.serve.batcher), dispatches
one `sort_batched` (or `semisort_batched`, `top_k_batched`) per batch,
and resolves the per-request futures in input order.

    svc = SortService(spec=SortSpec(exchange="allgather", tag=False))
    async with svc:
        sorted_np = await svc.submit(x)                  # one request
        order = await svc.submit(x, kind="argsort")

Admission control (a `max_queue_depth` cap on outstanding requests and a
`max_in_flight` batch semaphore, rejecting with the typed `Overloaded`),
per-request deadlines (expired requests are dropped from their batch and
never poison the others), graceful drain, and a `MetricsRegistry`
(per-bucket occupancy, flushes, latency and cache counters; `GET
/metrics`) ride along.

Self-healing (DESIGN.md Sec. 8): a failed batch retries with exponential
backoff; once the retries are spent it bisects, so one poison request
fails alone and its batchmates are served. Batches run on a
`SupervisedExecutor`: a worker poisoned mid-batch
(`repro_torch.runtime.chaos.ExecutorDeath` stands in for a wedged device
runtime) is torn down and rebuilt, at most `executor_max_restarts`
times. A per-bucket `CircuitBreaker` trips after `breaker_threshold`
consecutive batch failures and sends the bucket to a degraded
per-request path (unbatched front-door calls under each request's own
spec, its kernel policy included) until a cooldown probe succeeds; the
breaker board's ok | degraded | tripped is what `GET /healthz` serves.
A kernel that does not build, load or launch (`KernelError`) is none of
these faults: it fails the requests of its batch as it is, with no
retry, bisection or breaker event.

Verified serving (DESIGN.md Sec. 9): with `SortSpec(verify=...)` every
batch carries the fused audit. A `BatchVerificationError` is absorbed
per row: the verified rows are served from the same launch, each failed
row fails alone with a typed `VerificationError`, and a batch with failed
rows counts as a breaker failure, so repeated verify failures trip the
bucket onto the degraded path as crashes do.

Each batch is stacked on the host and copied to the spec's device once;
a CUDA spec with no card raises (`resolve_device`), the service never
moves work to the CPU by itself. Compute runs on the executor's one
worker thread, on that thread's current CUDA stream. Threaded callers
(the stdlib HTTP front end, benchmarks) use `ServiceRunner`, which owns
the event loop in a daemon thread and exposes a blocking `submit`.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.kernels.cuda import KernelError
from repro_torch.runtime import chaos
from repro_torch.runtime.ft import SupervisedExecutor
from repro_torch.serve.batcher import DynamicBatcher, Request
from repro_torch.serve.breaker import BreakerBoard
from repro_torch.serve.errors import (
    DeadlineExceeded, Overloaded, ServiceClosed)
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.sort import (
    BatchVerificationError, SortSpec, VerificationError, bucket_key,
    exec_cache, gather_perm_checked, semisort, semisort_batched,
    sort_batched, top_k, top_k_batched)
from repro_torch.sort import argsort as sort_argsort
from repro_torch.sort import sort as sort_single
from repro_torch.sort.api import resolve_device

KINDS = ("sort", "argsort", "sort_kv", "semisort", "top_k")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service knobs. Defaults favor throughput on a warm cache.

    max_batch        bucket flush size (and the batched-launch B ceiling).
    max_delay_ms     flush deadline: the latency bound a lone request pays.
    max_queue_depth  admission cap on outstanding (unresolved) requests;
                     beyond it `submit` raises Overloaded. A saturated
                     in-flight limit backs up into this queue, so one cap
                     bounds total memory whatever the bottleneck is.
    max_in_flight    batches allowed past flush at once (semaphore); the
                     compute itself runs one batch at a time on one
                     executor thread (one device), so this bounds the
                     flushed-but-unfinished pipeline, not device overlap.
    pad_batches      pad each batch B up to the next power of two (cap
                     max_batch) by repeating the last request's row, so a
                     bucket needs O(log max_batch) cache keys instead of
                     one per occupancy; pad rows are discarded
                     (per-request results are row-independent, so padding
                     does not change the served bits).
    default_timeout_s  per-request deadline when the caller passes none
                     (None = no deadline).
    latency_window   per-bucket latency reservoir size (p50/p99 basis).
    straggler_threshold  batch-time EWMA multiplier that flags a straggler
                     (repro_torch.runtime.ft.StepTimer).
    straggler_warmup  StepTimer warmup: the EWMA is seeded from the median
                     of the first k batch times, so a slow first batch
                     cannot poison the straggler baseline.
    max_batch_retries  failed-batch retry budget (exponential backoff);
                     past it the batch bisects to isolate a poison request.
    retry_backoff_s  base backoff between batch retries (doubles per try).
    breaker_threshold / breaker_cooldown_s  per-bucket circuit breaker:
                     consecutive top-level batch failures that trip it, and
                     how long it stays open before a half-open probe. The
                     degraded path keeps each request's kernel policy (the
                     reference's `fallback_kernel_policy="xla"` has no
                     counterpart: the port never moves a request off the
                     kernels by itself).
    executor_max_restarts  SupervisedExecutor restart budget.
    """
    max_batch: int = 8
    max_delay_ms: float = 5.0
    max_queue_depth: int = 256
    max_in_flight: int = 2
    pad_batches: bool = True
    default_timeout_s: float | None = None
    latency_window: int = 2048
    straggler_threshold: float = 3.0
    straggler_warmup: int = 3
    max_batch_retries: int = 2
    retry_backoff_s: float = 0.05
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    executor_max_restarts: int = 8


def _pad_pow2(b: int, cap: int) -> int:
    p = 1
    while p < b:
        p *= 2
    return min(p, cap)


class SortService:
    """Asyncio sort service over the batched engine."""

    def __init__(self, spec: SortSpec | None = None,
                 config: ServiceConfig | None = None):
        self.spec = spec if spec is not None else SortSpec()
        self.config = config or ServiceConfig()
        self._breakers = BreakerBoard(
            threshold=self.config.breaker_threshold,
            cooldown_s=self.config.breaker_cooldown_s)
        self.metrics = MetricsRegistry(
            window=self.config.latency_window,
            straggler_threshold=self.config.straggler_threshold,
            straggler_warmup=self.config.straggler_warmup,
            cache_stats=exec_cache.stats,
            health=self.health)
        self._batcher = DynamicBatcher(
            max_batch=self.config.max_batch,
            max_delay_s=self.config.max_delay_ms / 1e3,
            flush_cb=self._on_flush)
        # one dispatch thread: one device runs one batch at a time anyway,
        # and a single worker makes the per-batch cache delta attribution
        # exact; the supervisor rebuilds it if a batch poisons the worker
        # (DESIGN.md Sec. 8)
        self._executor = SupervisedExecutor(
            max_restarts=self.config.executor_max_restarts,
            thread_name_prefix="sort-serve-dispatch")
        self._sem: asyncio.Semaphore | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._queued = 0        # admitted, not yet handed to the executor
        self._outstanding = 0   # admitted, future not yet resolved
        self._in_flight = 0     # batches past the semaphore
        self._idle: asyncio.Event | None = None
        self._closed = False

    # -- submission --------------------------------------------------------

    def enqueue(self, x, *, kind: str = "sort", values=None,
                spec: SortSpec | None = None, param=None,
                timeout: float | None = None) -> asyncio.Future:
        """Admit one request; returns its asyncio future. Must be called
        on the service's event loop. Raises ServiceClosed / Overloaded
        synchronously when admission fails (nothing is queued)."""
        loop = asyncio.get_running_loop()
        if self._loop is None:
            self._loop = loop
            self._sem = asyncio.Semaphore(self.config.max_in_flight)
            self._idle = asyncio.Event()
            self._idle.set()
        elif loop is not self._loop:
            raise RuntimeError("SortService is bound to another event loop")
        if self._closed:
            self.metrics.observe_reject("closed")
            raise ServiceClosed("service is closed to new requests")
        if self._queued >= self.config.max_queue_depth:
            self.metrics.observe_reject("queue_full")
            raise Overloaded("queue_full", queued=self._queued,
                             in_flight=self._in_flight)
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        x = np.asarray(x)
        if x.ndim != 1 or x.size == 0:
            raise ValueError(
                f"requests must be non-empty 1-D key arrays, got {x.shape}")
        spec = spec if spec is not None else self.spec
        if kind in ("argsort", "sort_kv"):
            # the front door's normalization: exact permutations need
            # tagging (tag=False is the front door's ValueError too), and
            # the bucket key must reflect the normalized spec
            if spec.tag is False:
                raise ValueError(
                    f"{kind} requires tagging (spec sets tag=False)")
            spec = dataclasses.replace(spec, stable=True, tag=True)
        if kind == "sort_kv":
            values = np.asarray(values)
            if values.shape[:1] != x.shape:
                raise ValueError(
                    f"values leading dim {values.shape[:1]} != {x.shape}")
        if kind == "top_k":
            param = int(param) if param is not None else None
            if param is None or not 1 <= param <= x.shape[0]:
                raise ValueError(
                    f"top_k requires 1 <= k <= {x.shape[0]}, got {param!r}")
        else:
            param = None    # only top_k carries a launch-shaping param
        timeout = (timeout if timeout is not None
                   else self.config.default_timeout_s)
        req = Request(
            kind=kind, x=x, values=values, spec=spec,
            key=bucket_key(x.shape[0], x.dtype, spec, kind=kind, param=param),
            future=loop.create_future(), t_submit=loop.time(),
            deadline=None if timeout is None else loop.time() + timeout,
            param=param)
        self._queued += 1
        self._outstanding += 1
        self._idle.clear()
        self.metrics.observe_admit(req.key)
        self._batcher.add(req)
        return req.future

    async def submit(self, x, *, kind: str = "sort", values=None,
                     spec: SortSpec | None = None, param=None,
                     timeout: float | None = None):
        """Admit one request and await its result: the sorted keys
        (`kind="sort"`), the stable argsort permutation ("argsort"), a
        `(sorted_keys, permuted_values)` pair ("sort_kv"), the grouped
        keys ("semisort": equal keys contiguous, no total order
        promise), or the largest `param` keys descending ("top_k"), each
        a NumPy array, bit-identical to the corresponding direct
        `repro_torch.sort` call with the same spec and seed."""
        return await self.enqueue(x, kind=kind, values=values, spec=spec,
                                  param=param, timeout=timeout)

    # -- batch lifecycle ---------------------------------------------------

    def _on_flush(self, key, reqs, reason):
        self._loop.create_task(self._dispatch(key, reqs, reason))

    def _resolve(self, req: Request, result) -> None:
        fut = req.future
        if fut.cancelled():
            self.metrics.observe_cancelled(req.key)
        elif isinstance(result, BaseException):
            fut.set_exception(result)
        else:
            fut.set_result(result)
        self._outstanding -= 1
        if self._outstanding == 0:
            self._idle.set()

    async def _dispatch(self, key, reqs, reason):
        async with self._sem:
            self._queued -= len(reqs)
            now = self._loop.time()
            live = []
            for r in reqs:
                if r.future.cancelled():
                    self._resolve(r, None)   # just bookkeeping
                elif r.deadline is not None and now > r.deadline:
                    self.metrics.observe_expired(r.key)
                    self._resolve(r, DeadlineExceeded(
                        f"deadline passed after "
                        f"{now - r.t_submit:.3f}s in queue"))
                else:
                    live.append(r)
            if not live:
                return
            self._in_flight += 1
            queue_waits = [now - r.t_submit for r in live]
            t0 = time.monotonic()
            try:
                results, cache_delta = await self._execute(key, live)
            except KernelError as e:
                # the batch's requests get the kernel's own error: no
                # retry, bisection or breaker event reached this batch
                results, cache_delta = [e] * len(live), None
            finally:
                self._in_flight -= 1
            self.metrics.observe_batch(
                key, size=len(live), reason=reason,
                queue_waits_s=queue_waits, compute_s=time.monotonic() - t0,
                cache_delta=cache_delta)
            done = self._loop.time()
            for r, res in zip(live, results):
                self.metrics.observe_result(
                    r.key, done - r.t_submit,
                    ok=not isinstance(res, BaseException))
                self._resolve(r, res)

    async def _execute(self, key, reqs, *, top: bool = True):
        """Self-healing batch execution (DESIGN.md Sec. 8).

        Top level: the bucket's circuit breaker gates entry (open =>
        degraded per-request path), a failed launch retries with
        exponential backoff, and exactly one success/failure event is
        recorded on the breaker per flushed batch. Retries exhausted, the
        batch bisects (`top=False`: single attempt, no breaker events) so
        a poison request fails alone. Returns (results, cache_delta),
        exceptions as per-request values. A `KernelError` is raised as it
        is: a kernel that does not build or launch is no fault of the
        batch's data, so retrying, bisecting or tripping the breaker onto
        the degraded path (which runs the same kernels) would only hide
        it."""
        br = self._breakers.breaker(key)
        if top and not br.allow():
            return await self._execute_degraded(key, reqs), None
        attempts = (self.config.max_batch_retries + 1) if top else 1
        last_exc: BaseException | None = None
        for attempt in range(attempts):
            if attempt:
                self.metrics.observe_batch_retry(key)
                await asyncio.sleep(
                    self.config.retry_backoff_s * (2 ** (attempt - 1)))
            try:
                results, delta, verify_bad = await self._loop.run_in_executor(
                    self._executor, self._run_batch, reqs)
                if top:
                    # a batch with rows whose audit failed for good is a
                    # breaker failure even though its verified rows were
                    # served: repeated verify failures on a bucket mean
                    # the batched path (or the data under it) corrupts,
                    # and it must trip onto the degraded path like any
                    # other batch-level fault
                    if verify_bad:
                        br.record_failure()
                    else:
                        br.record_success()
                return results, delta
            except chaos.ExecutorDeath as e:
                # the worker itself is poisoned: restart the pool; the
                # retry loop (or the bisection below) re-runs the batch
                try:
                    self._executor.report_death()
                    self.metrics.observe_executor_restart()
                except RuntimeError as budget:
                    last_exc = budget
                    break
                last_exc = RuntimeError(f"executor died mid-batch: {e}")
            except asyncio.CancelledError:
                # our pending launch was cancelled by a pool restart
                # (cancel_futures=True): transient, retryable
                last_exc = RuntimeError("batch cancelled by executor restart")
            except KernelError:
                raise
            except Exception as e:
                last_exc = e
        if len(reqs) > 1:
            # bisection isolation: halves run independently (single
            # attempt each), recursing until the poison request is alone
            self.metrics.observe_bisection(key)
            mid = len(reqs) // 2
            left, dl = await self._execute(key, reqs[:mid], top=False)
            right, dr = await self._execute(key, reqs[mid:], top=False)
            delta = None
            if dl or dr:
                delta = {k: (dl or {}).get(k, 0) + (dr or {}).get(k, 0)
                         for k in ("hits", "misses", "evictions")}
            if top:
                br.record_failure()   # the batched path DID fail
            return left + right, delta
        if top:
            br.record_failure()
        return [last_exc] * len(reqs), None

    async def _execute_degraded(self, key, reqs):
        """Open-breaker path: serve each request alone through the
        unbatched front door, under its own spec. Slower, but it sidesteps
        the suspect batched path, and it feeds the breaker board the
        degraded-path health that tells "degraded" from "tripped". A
        request whose kernel does not build or launch gets that
        `KernelError` and feeds the board nothing."""
        results = []
        for r in reqs:
            try:
                res = await self._loop.run_in_executor(
                    self._executor, self._run_one, r)
                ok = True
            except chaos.ExecutorDeath as e:
                try:
                    self._executor.report_death()
                    self.metrics.observe_executor_restart()
                except RuntimeError:
                    pass
                res, ok = RuntimeError(f"executor died: {e}"), False
            except asyncio.CancelledError:
                res = RuntimeError("request cancelled by executor restart")
                ok = False
            except KernelError as e:
                results.append(e)
                continue
            except Exception as e:
                res, ok = e, False
            self.metrics.observe_degraded(key, ok=ok)
            self._breakers.record_degraded(key, ok)
            results.append(res)
        return results

    def _run_one(self, req: Request):
        """Executor thread: one request through the unbatched front door
        (the degraded path), under the request's own spec.
        Bit-identical to the batched result by the engine's batching
        parity contract."""
        chaos.on_dispatch(req.x)
        spec, x = req.spec, req.x
        if req.kind == "sort":
            return sort_single(x, spec).gather()
        if req.kind == "semisort":
            return semisort(x, spec=spec).gather()
        if req.kind == "top_k":
            return np.asarray(top_k(x, req.param, spec=spec))
        order = np.asarray(sort_argsort(x, spec))
        if req.kind == "argsort":
            return order
        return sort_single(x, spec).gather(), req.values[order]

    def _run_batch(self, reqs):
        """Executor thread: one batched launch for the batch.

        All requests share a bucket key, hence an (n,), dtype, kind, and
        spec, so stacking is safe. Returns per-request results in input
        order (exceptions as values: an overflow on one argsort request
        fails that request, not its batchmates), the bucket's cache
        delta, and the count of requests whose audit failed for good. A
        BatchVerificationError is absorbed here: its per-row verdicts
        save the verified rows (served exact from the same launch) while
        each failed row gets a typed VerificationError with its own row
        verdict. The batch goes to the device in one copy."""
        spec, kind = reqs[0].spec, reqs[0].kind
        b_real = len(reqs)
        xs = np.stack([r.x for r in reqs])
        chaos.on_dispatch(xs)   # fault-injection hook (no-op in prod)
        if self.config.pad_batches:
            b_pad = _pad_pow2(b_real, self.config.max_batch)
            if b_pad > b_real:   # repeat the last row; rows are independent
                xs = np.concatenate([xs, np.broadcast_to(
                    xs[-1], (b_pad - b_real,) + xs[-1].shape)])
        stats0 = exec_cache.stats()
        dev_xs = torch.from_numpy(xs).to(resolve_device(spec.device))
        verify_err = None
        row_ok = None
        try:
            if kind == "top_k":
                out = top_k_batched(dev_xs, reqs[0].param, spec=spec)
            elif kind == "semisort":
                out = semisort_batched(dev_xs, spec=spec)
            else:
                out = sort_batched(dev_xs, spec)
        except BatchVerificationError as e:
            # sort kinds only: semisort and top_k run no audit (DESIGN.md
            # Sec. 10), so they cannot raise this here; a tagged-fallback
            # semisort batch that does surfaces a BatchedSortOutput, whose
            # request(b).gather() below is still a valid (sorted) grouping
            verify_err, out = e, e.output
            row_ok = e.row_ok
        self.metrics.observe_recovery(
            reqs[0].key, getattr(out, "recovery", None))
        results = []
        verify_bad = 0
        for b in range(b_real):
            if row_ok is not None and not row_ok[b]:
                verify_bad += 1
                results.append(VerificationError(
                    f"request failed the device-side audit: {verify_err}",
                    verify_err.report.row(b)))
                continue
            if kind == "top_k":
                results.append(np.asarray(out[b]))
                continue
            if kind == "semisort":
                results.append(out.request(b).gather())
                continue
            r = out.request(b)
            if kind == "sort":
                results.append(r.gather())
                continue
            # exactness from the gathered LENGTH, no extra device sync on
            # the happy path (see repro_torch.sort.gather_perm_checked)
            try:
                order = gather_perm_checked(r, kind)
            except RuntimeError as e:
                results.append(e)
                continue
            if kind == "argsort":
                results.append(order)
            else:   # sort_kv
                results.append((r.gather(), reqs[b].values[order]))
        if verify_bad:
            self.metrics.observe_verify_failure(reqs[0].key, verify_bad)
        stats1 = exec_cache.stats()
        delta = {k: stats1[k] - stats0[k]
                 for k in ("hits", "misses", "evictions")}
        return results, delta, verify_bad

    # -- health ------------------------------------------------------------

    def health(self) -> dict:
        """Breaker-board health (ok | degraded | tripped), the per-bucket
        breaker states and the executor's restart counters: the /healthz
        body."""
        snap = self._breakers.full_snapshot()
        snap["executor"] = self._executor.snapshot()
        return snap

    # -- lifecycle ---------------------------------------------------------

    @property
    def queued(self) -> int:
        return self._queued

    @property
    def in_flight(self) -> int:
        return self._in_flight

    async def drain(self) -> None:
        """Flush every bucket now and wait for all outstanding requests
        (including in-flight batches) to resolve."""
        if self._idle is None:   # never used
            return
        self._batcher.flush_all("drain")
        await self._idle.wait()

    async def aclose(self) -> None:
        """Graceful shutdown: stop admitting, drain, release the
        dispatcher. Idempotent."""
        self._closed = True
        await self.drain()
        self._executor.shutdown(wait=True)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.aclose()
        return False


class ServiceRunner:
    """A SortService on its own event-loop thread, with a blocking API.

    The stdlib HTTP front end (repro_torch.serve.http) handles each
    connection on a thread; benchmarks and the smoke drills drive load
    from thread pools. Both need a thread-safe, blocking `submit`: this
    wrapper owns the asyncio loop in a daemon thread and bridges with
    `run_coroutine_threadsafe`.
    """

    def __init__(self, spec: SortSpec | None = None,
                 config: ServiceConfig | None = None):
        self._loop = asyncio.new_event_loop()
        started = threading.Event()

        def _run():
            asyncio.set_event_loop(self._loop)
            self._loop.call_soon(started.set)
            self._loop.run_forever()

        self._thread = threading.Thread(
            target=_run, name="sort-serve-loop", daemon=True)
        self._thread.start()
        started.wait()
        self.service = SortService(spec=spec, config=config)

    def submit(self, x, *, kind: str = "sort", values=None,
               spec: SortSpec | None = None, param=None,
               timeout: float | None = None):
        """Blocking submit from any thread; raises the service's typed
        errors (Overloaded, DeadlineExceeded, ServiceClosed)."""
        fut = asyncio.run_coroutine_threadsafe(
            self.service.submit(x, kind=kind, values=values, spec=spec,
                                param=param, timeout=timeout), self._loop)
        return fut.result()

    def metrics(self) -> dict:
        return self.service.metrics.snapshot()

    def health(self) -> dict:
        return self.service.health()

    def reset_metrics(self) -> None:
        self.service.metrics.reset()

    def drain(self) -> None:
        asyncio.run_coroutine_threadsafe(
            self.service.drain(), self._loop).result()

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(
            self.service.aclose(), self._loop).result()
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
