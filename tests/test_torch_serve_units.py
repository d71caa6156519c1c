"""The serving layer's stdlib units against the reference, driven through
the same sequence of events: `DynamicBatcher` (flush on size, deadline
and drain; depth), `CircuitBreaker` and `BreakerBoard` (an injected
clock), `MetricsRegistry` and `percentile`, `StepTimer` and
`SupervisedExecutor`. Snapshots must be equal; the batcher's flush
timing is wall-clock, so its flushes compare by bucket, order and
reason.
"""
import asyncio
import dataclasses
import threading

import numpy as np
import pytest

import repro.runtime.ft as rft
import repro.serve.batcher as rbatcher
import repro.serve.breaker as rbreaker
import repro.serve.metrics as rmetrics
import repro.sort as rsort
import repro_torch.runtime as truntime
import repro_torch.runtime.ft as tft
import repro_torch.serve as tserve
import repro_torch.serve.batcher as tbatcher
import repro_torch.serve.breaker as tbreaker
import repro_torch.serve.metrics as tmetrics
import repro_torch.sort as tsort

# -- the batcher -----------------------------------------------------------

# (bucket, request id) arrivals, then a drain; max_batch 3
ARRIVALS = [("a", 0), ("b", 1), ("a", 2), ("a", 3), ("c", 4), ("b", 5),
            ("a", 6), ("a", 7), ("a", 8), ("a", 9), ("b", 10)]


def _drive_batcher(mod, *, max_batch, max_delay_s, sleep_after=()):
    """Feed ARRIVALS to one package's DynamicBatcher: -> the flushes as
    (bucket, ids, reason) and the depth after each arrival."""
    async def run():
        loop = asyncio.get_running_loop()
        flushes, depths = [], []

        def flush(key, reqs, reason):
            flushes.append((key, [r.x for r in reqs], reason))

        b = mod.DynamicBatcher(max_batch=max_batch, max_delay_s=max_delay_s,
                               flush_cb=flush)
        for i, (key, rid) in enumerate(ARRIVALS):
            b.add(mod.Request(kind="sort", x=rid, values=None, spec=None,
                              key=key, future=loop.create_future(),
                              t_submit=loop.time()))
            depths.append(b.depth)
            if i in sleep_after:
                await asyncio.sleep(2 * max_delay_s)
        b.flush_all()
        depths.append(b.depth)
        return flushes, depths
    return asyncio.run(run())


@pytest.mark.parametrize("max_batch", [1, 3, 64])
@pytest.mark.parametrize("sleep_after", [(), (4,), (1, 5, 9)])
def test_batcher_flushes_like_reference(max_batch, sleep_after):
    want = _drive_batcher(rbatcher, max_batch=max_batch, max_delay_s=0.02,
                          sleep_after=sleep_after)
    got = _drive_batcher(tbatcher, max_batch=max_batch, max_delay_s=0.02,
                         sleep_after=sleep_after)
    assert got == want
    reasons = {r for _, _, r in got[0]}
    assert reasons <= {"size", "deadline", "drain"}


def test_batcher_rejects_empty_batch_size():
    for mod in (rbatcher, tbatcher):
        with pytest.raises(ValueError, match="max_batch"):
            mod.DynamicBatcher(max_batch=0, max_delay_s=0.1,
                               flush_cb=lambda *a: None)


# -- the breakers ----------------------------------------------------------


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# one event a step: ("fail"|"ok"|"allow"|"tick", arg)
BREAKER_EVENTS = [
    ("allow", None), ("fail", None), ("allow", None), ("fail", None),
    ("fail", None), ("allow", None), ("tick", 5.0), ("allow", None),
    ("tick", 6.0), ("allow", None), ("allow", None), ("fail", None),
    ("allow", None), ("tick", 10.0), ("allow", None), ("ok", None),
    ("allow", None), ("fail", None), ("ok", None), ("fail", None),
    ("fail", None), ("fail", None), ("tick", 10.0), ("allow", None),
    ("ok", None),
]


def _drive_breaker(mod):
    clock = Clock()
    br = mod.CircuitBreaker(threshold=3, cooldown_s=10.0, now=clock)
    seen = []
    for ev, arg in BREAKER_EVENTS:
        if ev == "tick":
            clock.t += arg
        elif ev == "allow":
            seen.append(("allow", br.allow()))
        elif ev == "fail":
            br.record_failure()
        else:
            br.record_success()
        seen.append((ev, br.state, br.snapshot()))
    return seen


def test_circuit_breaker_matches_reference():
    got, want = _drive_breaker(tbreaker), _drive_breaker(rbreaker)
    assert got == want
    states = {s for ev, *rest in got if ev != "allow" for s in rest[:1]}
    assert states == {"closed", "open", "half_open"}


def _drive_board(mod):
    clock = Clock()
    board = mod.BreakerBoard(threshold=2, cooldown_s=1.0, now=clock)
    seen = [board.full_snapshot()]
    for key in ("k1", "k2"):
        board.breaker(key)
    seen.append(board.full_snapshot())
    board.breaker("k1").record_failure()
    board.breaker("k1").record_failure()          # k1 open
    seen.append(board.full_snapshot())
    board.record_degraded("k1", True)
    seen.append(board.full_snapshot())            # degraded
    board.record_degraded("k1", False)
    seen.append(board.full_snapshot())            # tripped
    board.record_degraded("k2", False)            # k2 closed: no effect
    clock.t += 1.5
    seen.append(board.full_snapshot())            # half_open, still tripped
    assert board.breaker("k1").allow()
    board.breaker("k1").record_success()
    board.record_degraded("k1", True)
    seen.append(board.full_snapshot())            # ok
    assert board.breaker("k1") is board.breaker("k1")
    return seen


def test_breaker_board_matches_reference():
    got, want = _drive_board(tbreaker), _drive_board(rbreaker)
    assert got == want
    assert [s["health"] for s in got] == [
        "ok", "ok", "degraded", "degraded", "tripped", "tripped", "ok"]


# -- the metrics -----------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100, 1001])
def test_percentile_matches_reference(n):
    samples = list(np.random.default_rng(n).standard_normal(n))
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert tmetrics.percentile(samples, q) == \
            rmetrics.percentile(samples, q)


def _drive_metrics(mod, recovery_cls):
    """One sequence of observations; -> the snapshots along the way."""
    cache = {"hits": 0, "misses": 0}
    reg = mod.MetricsRegistry(
        window=4, straggler_threshold=2.0, straggler_warmup=2,
        cache_stats=lambda: dict(cache),
        health=lambda: {"health": "ok"})
    k1, k2 = ("sort", 256, "int32", ("fp",)), ("top_k", 384, "float32",
                                               ("fp",), 8)
    seen = [reg.snapshot()]
    for _ in range(3):
        reg.observe_admit(k1)
    reg.observe_admit(k2)
    reg.observe_reject("queue_full")
    reg.observe_reject("closed")
    reg.observe_reject("queue_full")
    reg.observe_expired(k1)
    reg.observe_cancelled(k2)
    slow = [reg.observe_batch(k1, size=2, reason="size",
                              queue_waits_s=[0.001, 0.004],
                              compute_s=c, cache_delta=d)
            for c, d in ((0.010, {"hits": 0, "misses": 1}),
                         (0.012, {"hits": 1, "misses": 0}),
                         (0.011, None), (0.050, {"hits": 1}),
                         (0.013, {"misses": 2, "evictions": 1}))]
    cache.update(hits=2, misses=3)
    reg.observe_batch(k2, size=1, reason="deadline", queue_waits_s=[0.02],
                      compute_s=0.02)
    reg.observe_batch_retry(k1)
    reg.observe_bisection(k1)
    reg.observe_executor_restart()
    reg.observe_degraded(k2)
    reg.observe_degraded(k2, ok=False)
    reg.observe_recovery(k1, None)
    reg.observe_recovery(k1, recovery_cls("retry", 3, (2.0, 4.0), False, 41))
    reg.observe_recovery(k1, recovery_cls(
        "raise", 1, (), False, 0, verify_failures=2, verify_retries=1,
        verify_fallback=True, achieved_imbalance=1.03))
    for x in (1.01, 1.2, 1.05, 1.0, 1.07):
        reg.observe_recovery(k2, recovery_cls("raise", 1, (), False, 0,
                                              achieved_imbalance=x))
    reg.observe_verify_failure(k1, 3)
    for i, lat in enumerate((0.1, 0.3, 0.2, 0.5, 0.4, 0.25)):
        reg.observe_result(k1 if i % 2 else k2, lat, ok=i != 3)
    seen.append(reg.snapshot())
    seen.append(slow)
    reg.reset()
    seen.append(reg.snapshot())
    return seen


def test_metrics_registry_matches_reference():
    got = _drive_metrics(tmetrics, tsort.RecoveryStats)
    want = _drive_metrics(rmetrics, rsort.RecoveryStats)
    assert got == want
    snap = got[1]
    assert snap["batch_timer"]["stragglers"] == 1 and got[2][3] is True
    assert snap["exec_cache"] == {"hits": 2, "misses": 3}
    assert snap["health"] == {"health": "ok"}


def test_metrics_latency_from_the_clock():
    """Served latencies come from the loop's clock: compare the keys and
    the sample counts, not the values."""
    got = _drive_metrics(tmetrics, tsort.RecoveryStats)[1]["buckets"]
    want = _drive_metrics(rmetrics, rsort.RecoveryStats)[1]["buckets"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k]["latency_ms"].keys() == want[k]["latency_ms"].keys()
        assert got[k]["latency_ms"]["samples"] == \
            want[k]["latency_ms"]["samples"]


# -- StepTimer and SupervisedExecutor --------------------------------------

STEPS = [0.5, 0.1, 0.12, 0.11, 0.4, 0.1, 0.09, 0.35, 0.1]


@pytest.mark.parametrize("kw", [dict(), dict(warmup=3),
                                dict(prior=0.1, threshold=3.0),
                                dict(alpha=0.5, warmup=2)])
def test_step_timer_matches_reference(kw):
    got, want = tft.StepTimer(**kw), rft.StepTimer(**kw)
    assert [got.record(s) for s in STEPS] == [want.record(s) for s in STEPS]
    assert got.snapshot() == want.snapshot()
    got.reset(), want.reset()
    assert got.snapshot() == want.snapshot()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _drive_executor(mod):
    ex = mod.SupervisedExecutor(max_restarts=2, thread_name_prefix="unit")
    seen = [ex.snapshot(), ex.submit(lambda a, b: a + b, 2, b=3).result()]
    gate, started = threading.Event(), threading.Event()

    def block():
        started.set()
        return gate.wait(10)

    blocker = ex.submit(block)
    started.wait(10)
    pending = ex.submit(lambda: "never")
    seen.append(ex.report_death())
    gate.set()
    seen.append(blocker.result(timeout=10))
    seen.append(pending.cancelled())
    names = ex.submit(lambda: threading.current_thread().name).result()
    seen.append(names.rsplit("_", 1)[0])
    seen.append(ex.report_death())
    with pytest.raises(RuntimeError, match="max_restarts=2"):
        ex.report_death()
    seen.append(ex.snapshot())
    ex.shutdown()
    with pytest.raises(RuntimeError):
        ex.submit(lambda: None)
    return seen


def test_supervised_executor_matches_reference():
    got, want = _drive_executor(tft), _drive_executor(rft)
    assert got == want
    assert got[-1] == {"restarts": 3, "max_restarts": 2}
    assert got[2:6] == [1, True, True, "unit-1"]


def test_exports_are_lazy_and_match_reference():
    import repro.serve as rserve
    import repro.serve.errors as rerrors
    assert sorted(tserve.__all__) == sorted(rserve.__all__)
    for name in tserve.__all__:
        assert getattr(tserve, name).__name__ == name
    assert truntime.SupervisedExecutor is tft.SupervisedExecutor
    assert issubclass(tserve.Overloaded, tserve.ServeError)
    e = tserve.Overloaded("queue_full", queued=3, in_flight=1)
    assert str(e) == str(rerrors.Overloaded("queue_full", queued=3,
                                            in_flight=1))
    assert (e.reason, e.queued, e.in_flight) == ("queue_full", 3, 1)
    with pytest.raises(AttributeError):
        tserve.TrainSupervisor
