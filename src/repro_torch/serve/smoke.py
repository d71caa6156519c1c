"""End-to-end serving smoke: the drills of the sort service (counterpart
of repro.serve.smoke).

    PYTHONPATH=src python -m repro_torch.serve.smoke --device cpu
    PYTHONPATH=src python -m repro_torch.serve.smoke --chaos --device cpu
    PYTHONPATH=src python -m repro_torch.serve.smoke --corrupt --device cpu

`--device` defaults to cuda (it raises without a card); `--shards` is p
(8). Each drill is also a function (`main`, `chaos_main`,
`corrupt_main`) that takes the request length and the device.

Steady state (`main`) starts the HTTP front end in the process, warms
every (bucket, padded batch size) cache key, resets the metrics, then
fires 64 concurrent requests of two shapes over HTTP and checks:

  * every response is exactly the NumPy sort of its input (bit-identity
    through the whole batch and HTTP path);
  * the cache's hit rate over the measured window is above 0.9;
  * admission control rejects cleanly (HTTP 429) past the queue limit
    (`overload_burst`).

The chaos and corrupt drills call `ServiceRunner.submit` from threads
and check the service's typed errors (the reference's go over HTTP; the
front end's status mapping is `main`'s and the HTTP tests' to check).

Chaos (`--chaos`, DESIGN.md Sec. 8) runs the service under an armed
`repro_torch.runtime.chaos.FaultPlan`: the dense exchange's capacity
clamped to force real overflow on every batch, one injected dispatch
crash, one injected executor death and a poison request. It checks the
self-healing contract:

  * every other request is still exact (overflow recovered by
    `on_overflow="retry"`, the crash by a batch retry, the dead executor
    by a supervisor restart, the poison's batchmates by bisection);
  * the poison request alone fails, naming the injected fault;
  * once the plan is disarmed, clean traffic serves and the health is
    "ok".

Corrupt (`--corrupt`, DESIGN.md Sec. 9) serves under an armed bit flip
(`FaultPlan(corrupt_at=True, corrupt_key=...)`) with
`SortSpec(verify="cheap")` and checks the verified-serving contract:

  * the marked request fails with the typed `VerificationError`, while
    its batchmates are served exact from the same launch (per-row
    verdicts, no bisection);
  * repeated verify failures open the bucket's breaker ("degraded"), and
    a clean request sent while it is open is served by the degraded
    per-request path, still audited, under the armed plan;
  * once the plan is disarmed and the cooldown has passed, a probe
    closes the breaker (health "ok" again) and clean traffic is cache
    hits only: the corrupted launches never entered the cache.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SHAPES = (8 * 32, 8 * 48)
LOAD = 64


def _post(base: str, route: str, payload: dict):
    req = urllib.request.Request(
        base + route, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(base: str, route: str):
    try:
        with urllib.request.urlopen(base + route, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class _Server:
    """The HTTP front end on 127.0.0.1, port 0, served from a daemon
    thread."""

    def __init__(self, runner):
        from repro_torch.serve.http import make_server

        self.server = make_server(runner, port=0)
        host, port = self.server.server_address[:2]
        self.base = f"http://{host}:{port}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def sort(self, x: np.ndarray):
        return _post(self.base, "/v1/sort",
                     {"keys": x.tolist(), "dtype": "int32"})

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _outcome(runner, x: np.ndarray, **kw):
    """One blocking `runner.submit`: its result, or the error it raised."""
    try:
        return runner.submit(x, **kw)
    except Exception as e:
        return e


def _check_sorted(x: np.ndarray, got) -> None:
    assert not isinstance(got, BaseException), repr(got)
    np.testing.assert_array_equal(got, np.sort(x))


def _warm_executables(spec, rng, *, max_batch: int, shapes=SHAPES) -> None:
    """Record every (shape, padded batch size) cache key the service can
    dispatch: it pads batches to powers of two <= max_batch, so this is
    the whole warm set, with no race on flush timing."""
    from repro_torch.sort import sort_batched
    for n in shapes:
        b = 1
        while b <= max_batch:
            xs = np.stack([rng.permutation(4 * n)[:n].astype(np.int32)
                           for _ in range(b)])
            sort_batched(xs, spec)
            b *= 2


def _spec(device: str, shards: int, **fields):
    from repro_torch.sort import SortSpec

    return SortSpec(shards=shards, device=device, **fields)


def chaos_main(*, n: int = 8 * 64, clamp_pair_cap: int = 8,
               device: str = "cuda", shards: int = 8) -> dict:
    """The fault drill: overflow clamp, crash, death and poison, live.
    Returns the metrics snapshot, chaos.stats() and the executor's
    restarts."""
    from repro_torch.runtime import chaos
    from repro_torch.serve.service import ServiceConfig, ServiceRunner

    rng = np.random.default_rng(0)
    spec = _spec(device, shards, exchange="dense", on_overflow="retry",
                 tag=False)
    config = ServiceConfig(max_batch=4, max_delay_ms=150.0,
                           max_queue_depth=256, max_in_flight=2)

    def fresh(poison: bool = False) -> np.ndarray:
        x = rng.permutation(4 * n)[:n].astype(np.int32)
        if poison:
            x[0] = -7   # inputs are non-negative, so -7 is the poison key
        return x

    with ServiceRunner(spec=spec, config=config) as runner:
        def one(x):
            return _outcome(runner, x)

        plan = chaos.FaultPlan(clamp_pair_cap=clamp_pair_cap,
                               crash_at=(1,), die_at=(2,), poison_key=-7)
        with chaos.activate(plan):
            # wave A: clean load under clamp + crash + death; every batch
            # overflows (retry escalation), dispatch 1 crashes (batch
            # retry), dispatch 2 dies (supervisor restart)
            inputs = [fresh() for _ in range(12)]
            with ThreadPoolExecutor(8) as pool:
                out = list(pool.map(one, inputs))
            for x, got in zip(inputs, out):
                _check_sorted(x, got)

            # wave B: a poison request among three clean batchmates;
            # bisection must isolate it
            wave = [fresh(poison=(i == 1)) for i in range(4)]
            with ThreadPoolExecutor(4) as pool:
                out = list(pool.map(one, wave))
            for i, (x, got) in enumerate(zip(wave, out)):
                if i == 1:
                    assert isinstance(got, Exception), got
                    assert "poison" in f"{type(got).__name__}: {got}", got
                else:
                    _check_sorted(x, got)
            fired = chaos.stats()
        print(f"chaos fired: {fired}")
        assert fired["crash"] >= 1 and fired["death"] >= 1, fired
        assert fired["poison"] >= 1, fired

        # plan disarmed: clean traffic must serve and health be ok
        for _ in range(4):
            x = fresh()
            _check_sorted(x, one(x))
        health = runner.health()
        assert health["health"] == "ok", health

        m = runner.metrics()
        print(f"served={m['served']} errors={m['errors']} "
              f"batch_retries={m['batch_retries']} "
              f"bisections={m['bisections']} "
              f"executor_restarts={m['executor_restarts']} "
              f"overflow_retries={m['overflow_retries']} "
              f"overflow_recovered={m['overflow_recovered']} "
              f"health={m['health']['health']}")
        assert m["served"] == 12 + 3 + 4, m["served"]
        assert m["errors"] == 1, m["errors"]          # the poison only
        assert m["batch_retries"] >= 1, m
        assert m["bisections"] >= 1, m
        assert m["executor_restarts"] >= 1, m
        assert m["overflow_retries"] >= 1, m
        assert m["overflow_recovered"] > 0, m
    print("serve chaos smoke: OK")
    return {"metrics": m, "chaos": fired,
            "executor": health["executor"]}


def corrupt_main(*, n: int = 8 * 64, device: str = "cuda", shards: int = 8,
                 cooldown_s: float = 0.5) -> dict:
    """The audit drill: a bit flip on the device, served. `cooldown_s`
    is the breaker's: the clean request sent while it is open must reach
    it inside the cooldown, so a caller whose requests take longer than
    a fraction of the reference's 0.5 s passes more. Returns the metrics
    of the armed window, chaos.stats() and the clean window's cache hits
    and misses."""
    import dataclasses
    import time as _time

    from repro_torch.runtime import chaos
    from repro_torch.serve.service import ServiceConfig, ServiceRunner
    from repro_torch.sort import VerificationError, sort_batched

    rng = np.random.default_rng(0)
    spec = _spec(device, shards, exchange="allgather", tag=False,
                 verify="cheap")
    config = ServiceConfig(max_batch=4, max_delay_ms=150.0,
                           breaker_threshold=2, breaker_cooldown_s=cooldown_s)

    def fresh(marked: bool = False) -> np.ndarray:
        x = rng.permutation(4 * n)[:n].astype(np.int32)
        if marked:
            x[0] = -7   # inputs are non-negative: -7 marks the corrupt row
        return x

    # warm the clean verified keys (B = 1, 2, 4); the corrupted launches
    # below must never count as hits of, or enter, these lines
    for b in (1, 2, 4):
        sort_batched(np.stack([fresh() for _ in range(b)]), spec)

    with ServiceRunner(spec=spec, config=config) as runner:
        def one(x, **kw):
            return _outcome(runner, x, **kw)

        runner.reset_metrics()
        plan = chaos.FaultPlan(corrupt_at=True, corrupt_key=-7)
        with chaos.activate(plan):
            # wave A: one marked request among three clean batchmates;
            # the audit fails exactly the marked row, the others are
            # served exact from the same launch
            wave = [fresh(marked=(i == 2)) for i in range(4)]
            with ThreadPoolExecutor(4) as pool:
                out = list(pool.map(one, wave))
            for i, (x, got) in enumerate(zip(wave, out)):
                if i == 2:
                    assert isinstance(got, VerificationError), got
                else:
                    _check_sorted(x, got)

            # wave B: marked requests one at a time, each its own batch,
            # until the repeated verify failures open the breaker
            clean = fresh()
            marked_total = 1   # wave A's marked request
            for _ in range(6):
                got = one(fresh(marked=True))
                assert isinstance(got, VerificationError), got
                marked_total += 1
                health = runner.health()
                if health["health"] != "ok":
                    break
            else:
                raise AssertionError(f"breaker never tripped: {health}")
            trips = sum(b["trips"] for b in health["breakers"].values())
            assert trips >= 1, health

            # open breaker: a clean request takes the degraded per-request
            # path, still audited, still under the armed plan
            states = [b["state"] for b in health["breakers"].values()]
            assert "open" in states, (
                f"breaker {states} before the clean request: the cooldown "
                f"({cooldown_s} s) is shorter than a request")
            _check_sorted(clean, one(clean))
            assert runner.metrics()["degraded_requests"] >= 1, (
                "the clean request missed the open breaker")
            fired = chaos.stats()
        print(f"corrupt fired: {fired}")
        assert fired["corrupt"] >= 3, fired

        # plan disarmed: once the cooldown has passed, a probe closes the
        # breaker and health returns to ok
        for _ in range(4):
            _time.sleep(config.breaker_cooldown_s + 0.2)
            x = fresh()
            _check_sorted(x, one(x))
            health = runner.health()
            if health["health"] == "ok":
                break
        assert health["health"] == "ok", health

        m = runner.metrics()
        print(f"served={m['served']} errors={m['errors']} "
              f"verify_failures={m['verify_failures']} "
              f"verify_failed_requests={m['verify_failed_requests']} "
              f"degraded_requests={m['degraded_requests']} "
              f"bisections={m['bisections']} "
              f"health={m['health']['health']}")
        assert 2 <= m["verify_failed_requests"] <= marked_total, m
        assert m["errors"] == marked_total, m
        assert m["bisections"] == 0, m   # per-row verdicts, no bisection
        bucket_fail = sum(b["verify_failures"]
                          for b in m["buckets"].values())
        assert bucket_fail >= 2, m["buckets"]

        # the clean window: warm clean traffic must be hits only, the
        # corrupted launches bypassed the cache
        runner.reset_metrics()
        wave = [fresh() for _ in range(4)]
        with ThreadPoolExecutor(4) as pool:
            out = list(pool.map(one, wave))
        for x, got in zip(wave, out):
            _check_sorted(x, got)
        clean = runner.metrics()
        hits = sum(b["cache"]["hits"] for b in clean["buckets"].values())
        misses = sum(b["cache"]["misses"] for b in clean["buckets"].values())
        print(f"clean window: cache_hits={hits} cache_misses={misses}")
        assert hits > 0 and misses == 0, (hits, misses)

        # the verify tier is the caller's to override through the spec: a
        # full-tier request records its own clean line
        x = fresh()
        _check_sorted(x, one(x, spec=dataclasses.replace(spec,
                                                         verify="full")))
    print("serve corrupt smoke: OK")
    return {"metrics": m, "chaos": fired, "clean_hits": hits,
            "clean_misses": misses}


def overload_burst(spec, x: np.ndarray) -> list:
    """A concurrent burst of 8 over HTTP past max_queue_depth=4 must
    bounce at least one 429 while the admitted requests serve; returns
    the status codes."""
    from repro_torch.serve.service import ServiceConfig, ServiceRunner

    tiny = ServiceConfig(max_batch=64, max_delay_ms=500.0, max_queue_depth=4)
    with ServiceRunner(spec=spec, config=tiny) as small:
        server = _Server(small)
        try:
            with ThreadPoolExecutor(8) as pool:
                replies = list(pool.map(lambda _: server.sort(x), range(8)))
        finally:
            server.close()
    codes = [c for c, _ in replies]
    assert 429 in codes, f"no 429 under overload: {codes}"
    assert 200 in codes, f"admitted requests must still serve: {codes}"
    for code, body in replies:
        if code == 200:
            np.testing.assert_array_equal(
                np.asarray(body["sorted"], np.int32), np.sort(x))
    print(f"overload burst codes: {sorted(codes)}")
    return codes


def main(*, shapes=SHAPES, load: int = LOAD, device: str = "cuda",
         shards: int = 8) -> dict:
    """The steady-state drill over HTTP; returns the measured window's
    metrics and the overload burst's status codes."""
    from repro_torch.serve.service import ServiceConfig, ServiceRunner

    spec = _spec(device, shards, exchange="allgather", tag=False)
    config = ServiceConfig(max_batch=4, max_delay_ms=10.0,
                           max_queue_depth=256, max_in_flight=2)
    rng = np.random.default_rng(0)
    _warm_executables(spec, rng, max_batch=config.max_batch, shapes=shapes)

    with ServiceRunner(spec=spec, config=config) as runner:
        server = _Server(runner)
        try:
            runner.reset_metrics()

            # the measured window: concurrent load of two shapes
            inputs = [rng.permutation(4 * shapes[i % len(shapes)])
                      [:shapes[i % len(shapes)]].astype(np.int32)
                      for i in range(load)]

            def one(x):
                status, body = server.sort(x)
                assert status == 200, body
                return np.asarray(body["sorted"], np.int32)

            with ThreadPoolExecutor(16) as pool:
                results = list(pool.map(one, inputs))
            for x, got in zip(inputs, results):
                np.testing.assert_array_equal(got, np.sort(x))

            _, metrics = _get(server.base, "/metrics")
            hits = sum(b["cache"]["hits"]
                       for b in metrics["buckets"].values())
            misses = sum(b["cache"]["misses"]
                         for b in metrics["buckets"].values())
            hit_rate = hits / max(hits + misses, 1)
            print(f"served={metrics['served']} batches={metrics['batches']} "
                  f"cache_hits={hits} cache_misses={misses} "
                  f"hit_rate={hit_rate:.3f}")
            assert metrics["served"] == load, metrics
            assert hits > 0, "no cache hits under load"
            assert hit_rate > 0.9, f"warm hit rate {hit_rate:.3f} <= 0.9"
        finally:
            server.close()

    x = rng.permutation(4 * shapes[0])[:shapes[0]].astype(np.int32)
    codes = overload_burst(spec, x)
    print("serve smoke: OK")
    return {"metrics": metrics, "hit_rate": hit_rate, "codes": codes}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chaos", action="store_true",
                    help="run the fault-injection drill instead of the "
                         "steady-state smoke")
    ap.add_argument("--corrupt", action="store_true",
                    help="run the silent-corruption audit drill instead of "
                         "the steady-state smoke")
    ap.add_argument("--device", default="cuda",
                    help="where the sorts run (cuda raises without a card)")
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args(argv)
    kw = dict(device=args.device, shards=args.shards)
    if args.chaos:
        chaos_main(**kw)
    elif args.corrupt:
        corrupt_main(**kw)
    else:
        main(**kw)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
