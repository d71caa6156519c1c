"""The sort service (repro_torch.serve) against the reference's and the
port's own front doors: each kind served (sort, argsort, sort_kv,
semisort, top_k) equals the direct call on the same spec and the
reference service's result for the same inputs (semisort: the same
groups, each key's copies contiguous, since the grouping order depends on
the draws); padded batches use the power-of-two cache line; deadlines,
admission (Overloaded), drain and close; an argsort overflow fails its
own request alone; and the HTTP routes on 127.0.0.1.

No pytest-asyncio here: async tests run under `asyncio.run`.
"""
import asyncio
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import repro.serve as rserve
import repro_torch.serve as tserve
import repro_torch.sort as tsort
from repro.sort import SortSpec as RefSortSpec
from repro_torch.data import distributions as tdist
from repro_torch.serve.http import make_server
from repro_torch.sort import SortSpec
from torch_parity import auto_mesh

SPEC = SortSpec(exchange="allgather", tag=False, shards=8, device="cpu")
ASPEC = SortSpec(exchange="allgather", shards=8, device="cpu")
N1, N2 = 8 * 32, 8 * 48
CONFIG = tserve.ServiceConfig(max_batch=4, max_delay_ms=20.0)


def _keys(rng, n):
    return rng.permutation(4 * n)[:n].astype(np.int32)


def _serve_all(mod, spec, aspec, config, reqs):
    """Submit every (kind, x, values, param) request at once to one
    package's service; -> the results in order (exceptions as values)."""
    async def run():
        async with mod.SortService(spec=spec, config=config) as svc:
            futs = []
            for kind, x, values, param in reqs:
                s = aspec if kind in ("argsort", "sort_kv") else spec
                futs.append(svc.enqueue(x, kind=kind, values=values, spec=s,
                                        param=param))
            return await asyncio.gather(*futs, return_exceptions=True)
    return asyncio.run(run())


def _groups(a):
    keys, counts = np.unique(a, return_counts=True)
    # each key's copies contiguous: as many runs as distinct keys
    runs = 1 + int(np.count_nonzero(a[1:] != a[:-1]))
    assert runs == keys.shape[0]
    return keys, counts


def test_each_kind_matches_direct_and_reference():
    rng = np.random.default_rng(3)
    z = [tdist.make_adversarial("ZIPF_HH", N1, seed=s) for s in range(4)]
    xs = [_keys(rng, N1) for _ in range(4)]
    vals = [rng.standard_normal((N1, 2)).astype(np.float32)
            for _ in range(4)]
    reqs = ([("sort", x, None, None) for x in xs]
            + [("argsort", x, None, None) for x in xs]
            + [("sort_kv", x, v, None) for x, v in zip(xs, vals)]
            + [("semisort", x, None, None) for x in z]
            + [("top_k", x, None, 40) for x in xs])
    got = _serve_all(tserve, SPEC, ASPEC, CONFIG, reqs)
    mesh = auto_mesh(8)
    want = _serve_all(
        rserve, RefSortSpec(exchange="allgather", tag=False, mesh=mesh),
        RefSortSpec(exchange="allgather", mesh=mesh),
        rserve.ServiceConfig(max_batch=4, max_delay_ms=20.0), reqs)
    for (kind, x, values, param), g, w in zip(reqs, got, want):
        if kind == "sort":
            direct = tsort.sort(x, SPEC).gather()
        elif kind == "argsort":
            direct = tsort.argsort(x, ASPEC)
        elif kind == "sort_kv":
            direct = tsort.sort_kv(x, values, ASPEC)
        elif kind == "semisort":
            direct = tsort.semisort(x, spec=SPEC).gather()
        else:
            direct = tsort.top_k(x, param, SPEC)
        if kind == "sort_kv":
            for a, b, c in zip(g, direct, w):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
            continue
        np.testing.assert_array_equal(g, direct)
        if kind == "semisort":
            for a, b in zip(_groups(g), _groups(np.asarray(w))):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)
            assert g.dtype == np.asarray(w).dtype


def test_padded_batch_uses_the_power_of_two_line():
    """Three requests pad to B = 4 (the last row repeated): the results
    are the rows' own, and the batch ran on the (4, n) cache line."""
    rng = np.random.default_rng(5)
    xs = [_keys(rng, N2) for _ in range(3)]
    tsort.sort_batched(np.stack(xs + [xs[-1]]), SPEC)   # warm (4, N2)
    stats0 = tsort.exec_cache.stats()

    async def run():
        async with tserve.SortService(spec=SPEC, config=CONFIG) as svc:
            futs = [svc.enqueue(x) for x in xs]
            await svc.drain()
            out = [await f for f in futs]
            return out, svc.metrics.snapshot()
    out, snap = asyncio.run(run())
    for x, got in zip(xs, out):
        np.testing.assert_array_equal(got, np.sort(x))
    (bucket,) = snap["buckets"].values()
    assert bucket["cache"] == {"hits": 1, "misses": 0, "hit_rate": 1.0}
    assert bucket["flush_reasons"] == {"drain": 1}
    assert bucket["mean_occupancy"] == 3.0
    assert tsort.exec_cache.stats()["hits"] == stats0["hits"] + 1
    no_pad = tserve.ServiceConfig(max_batch=4, max_delay_ms=20.0,
                                  pad_batches=False)

    async def run_unpadded():
        async with tserve.SortService(spec=SPEC, config=no_pad) as svc:
            futs = [svc.enqueue(x) for x in xs]
            await svc.drain()
            return [await f for f in futs], svc.metrics.snapshot()
    out, snap = asyncio.run(run_unpadded())
    for x, got in zip(xs, out):
        np.testing.assert_array_equal(got, np.sort(x))
    (bucket,) = snap["buckets"].values()
    assert bucket["cache"]["misses"] == 1   # the (3, n) line is new


def test_flush_on_size_then_deadline():
    rng = np.random.default_rng(6)

    async def run():
        async with tserve.SortService(spec=SPEC, config=CONFIG) as svc:
            full = [svc.enqueue(_keys(rng, N1)) for _ in range(4)]
            await asyncio.gather(*full)
            await svc.submit(_keys(rng, N1))
            return svc.metrics.snapshot()
    snap = asyncio.run(run())
    (bucket,) = snap["buckets"].values()
    assert bucket["flush_reasons"] == {"size": 1, "deadline": 1}
    assert snap["served"] == 5 and snap["batches"] == 2


def test_expired_deadline_fails_alone():
    rng = np.random.default_rng(7)

    async def run():
        async with tserve.SortService(spec=SPEC, config=CONFIG) as svc:
            dead = svc.enqueue(_keys(rng, N1), timeout=0.0)
            live = [_keys(rng, N1) for _ in range(3)]
            futs = [svc.enqueue(x) for x in live]
            with pytest.raises(tserve.DeadlineExceeded):
                await dead
            for x, f in zip(live, futs):
                np.testing.assert_array_equal(await f, np.sort(x))
            return svc.metrics.snapshot()
    snap = asyncio.run(run())
    assert snap["expired"] == 1 and snap["served"] == 3


def test_admission_drain_and_close():
    rng = np.random.default_rng(8)
    cfg = tserve.ServiceConfig(max_batch=64, max_delay_ms=1000.0,
                               max_queue_depth=3)

    async def run():
        svc = tserve.SortService(spec=SPEC, config=cfg)
        x = _keys(rng, N1)
        futs = [svc.enqueue(x) for _ in range(3)]
        with pytest.raises(tserve.Overloaded) as exc:
            svc.enqueue(x)
        assert exc.value.queued == 3
        await svc.drain()
        for f in futs:
            np.testing.assert_array_equal(await f, np.sort(x))
        await svc.aclose()
        with pytest.raises(tserve.ServiceClosed):
            svc.enqueue(x)
        return svc.metrics.snapshot()
    snap = asyncio.run(run())
    assert snap["rejected"] == {"queue_full": 1, "closed": 1}
    (bucket,) = snap["buckets"].values()
    assert bucket["flush_reasons"] == {"drain": 1}


def test_enqueue_validates_like_reference():
    rng = np.random.default_rng(9)

    async def run():
        async with tserve.SortService(spec=SPEC, config=CONFIG) as svc:
            with pytest.raises(ValueError, match="kind"):
                svc.enqueue(_keys(rng, N1), kind="median")
            with pytest.raises(ValueError, match="1-D"):
                svc.enqueue(np.zeros((4, 4), np.int32))
            with pytest.raises(ValueError, match="leading dim"):
                svc.enqueue(_keys(rng, N1), kind="sort_kv",
                            values=np.zeros((3, 2)), spec=ASPEC)
            with pytest.raises(ValueError, match="tag"):
                svc.enqueue(_keys(rng, N1), kind="argsort")
            with pytest.raises(ValueError, match="k <="):
                svc.enqueue(_keys(rng, N1), kind="top_k", param=N1 + 1)
    asyncio.run(run())


def test_argsort_overflow_fails_its_own_request():
    """Dense exchange under "raise": a presorted request drops keys and
    fails from gather_perm_checked; its UNIF batchmate is served."""
    spec = SortSpec(exchange="dense", shards=8, device="cpu")
    x_ok = tdist.make_distribution("UNIF", N2, seed=1)
    x_bad = tdist.make_adversarial("PRESORTED", N2, seed=1)

    async def run():
        async with tserve.SortService(spec=spec, config=CONFIG) as svc:
            futs = [svc.enqueue(x, kind="argsort") for x in (x_ok, x_bad)]
            await svc.drain()
            return await asyncio.gather(*futs, return_exceptions=True)
    good, bad = asyncio.run(run())
    np.testing.assert_array_equal(good, np.argsort(x_ok, kind="stable"))
    assert isinstance(bad, RuntimeError) and "dropped" in str(bad)


def _http(base, route, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        base + route, data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_http_routes():
    rng = np.random.default_rng(10)
    with tserve.ServiceRunner(spec=SPEC, config=CONFIG) as runner:
        server = make_server(runner, port=0)
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            xs = [_keys(rng, N1) for _ in range(4)]
            with ThreadPoolExecutor(4) as pool:
                replies = list(pool.map(lambda x: _http(
                    base, "/v1/sort", {"keys": x.tolist(),
                                       "dtype": "int32"}), xs))
            for x, (code, body) in zip(xs, replies):
                assert code == 200
                np.testing.assert_array_equal(body["sorted"], np.sort(x))
            x = xs[0]
            aspec = {"tag": None, "stable": True}
            code, body = _http(base, "/v1/argsort",
                               {"keys": x.tolist(), "spec": aspec})
            assert code == 200
            np.testing.assert_array_equal(body["indices"], np.argsort(x))
            v = np.arange(N1, dtype=np.int32)[::-1]
            code, body = _http(base, "/v1/sort_kv",
                               {"keys": x.tolist(), "values": v.tolist(),
                                "spec": aspec})
            assert code == 200
            order = np.argsort(x, kind="stable")
            np.testing.assert_array_equal(body["keys"], x[order])
            np.testing.assert_array_equal(body["values"], v[order])
            z = tdist.make_adversarial("ZIPF_HH", N1, seed=2)
            code, body = _http(base, "/v1/semisort", {"keys": z.tolist()})
            assert code == 200
            g = np.asarray(body["grouped"])
            for a, b in zip(_groups(g), np.unique(z, return_counts=True)):
                np.testing.assert_array_equal(a, b)
            f = rng.standard_normal(N1).astype(np.float32)
            code, body = _http(base, "/v1/top_k",
                               {"keys": f.tolist(), "k": 5})
            assert code == 200
            np.testing.assert_array_equal(
                np.asarray(body["top"], np.float32), np.sort(f)[::-1][:5])

            code, health = _http(base, "/healthz")
            assert code == 200 and health["health"] == "ok"
            assert health["executor"]["restarts"] == 0
            code, snap = _http(base, "/metrics")
            assert code == 200 and snap["served"] == 8
            assert "exec_cache" in snap
            assert _http(base, "/metrics/reset", {})[0] == 200
            assert _http(base, "/metrics")[1]["served"] == 0

            assert _http(base, "/v1/sort", {"keys": []})[0] == 400
            assert _http(base, "/v1/sort", {"keys": [1, 2],
                                            "spec": {"shards": 2}})[0] == 400
            assert _http(base, "/v1/top_k", {"keys": [1, 2],
                                             "k": "two"})[0] == 400
            assert _http(base, "/v1/median", {"keys": [1]})[0] == 404
            assert _http(base, "/nowhere")[0] == 404
        finally:
            server.shutdown()
            server.server_close()


def _served_with(monkeypatch, batched, spec, config, xs, *, then=()):
    """Serve `xs` at once with the service module's `sort_batched`
    replaced by `batched`, then each of `then` alone with the real one
    back: -> (results, results of `then`, metrics, health)."""
    import repro_torch.serve.service as svc_mod
    real = svc_mod.sort_batched

    async def run():
        async with tserve.SortService(spec=spec, config=config) as svc:
            monkeypatch.setattr(svc_mod, "sort_batched", batched)
            futs = [svc.enqueue(x) for x in xs]
            await svc.drain()
            out = await asyncio.gather(*futs, return_exceptions=True)
            monkeypatch.setattr(svc_mod, "sort_batched", real)
            after = []
            for x in then:
                after.append((await asyncio.gather(
                    svc.enqueue(x), return_exceptions=True))[0])
            return out, after, svc.metrics.snapshot(), svc.health()
    return asyncio.run(run())


def test_kernel_error_fails_its_batch_without_retry_or_breaker(monkeypatch):
    """A kernel that does not build or launch reaches every request of
    its batch as the KernelError it is: no batch retry, no bisection, no
    breaker event, so the bucket never moves onto the degraded path."""
    from repro_torch.kernels.cuda import KernelError

    calls = []

    def broken(xs, spec):
        calls.append(xs.shape)
        raise KernelError("CUDA kernel bitonic_sort_blocks failed")

    rng = np.random.default_rng(12)
    xs = [_keys(rng, N1) for _ in range(4)]
    later = _keys(rng, N1)
    config = tserve.ServiceConfig(max_batch=4, max_delay_ms=1000.0,
                                  breaker_threshold=1, retry_backoff_s=0.001)
    out, (after,), m, health = _served_with(
        monkeypatch, broken, SPEC, config, xs, then=[later])
    assert all(isinstance(r, KernelError) for r in out), out
    assert calls == [(4, N1)]
    assert (m["batch_retries"], m["bisections"], m["errors"]) == (0, 0, 4)
    assert m["degraded_requests"] == 0
    np.testing.assert_array_equal(after, np.sort(later))
    assert health["health"] == "ok"
    assert all(b["failures"] == 0 and b["trips"] == 0
               for b in health["breakers"].values())


def test_degraded_path_keeps_the_request_kernel_policy(monkeypatch):
    """Once a bucket's breaker opens, its requests are served one at a
    time under their own spec: the kernel policy they asked for stays."""
    import repro_torch.serve.service as svc_mod

    seen = []
    real_single = svc_mod.sort_single

    def single(x, spec):
        seen.append(spec)
        return real_single(x, spec)
    monkeypatch.setattr(svc_mod, "sort_single", single)

    def failing(xs, spec):
        raise RuntimeError("batched path down")

    spec = SortSpec(exchange="allgather", tag=False, shards=8,
                    device="cpu", kernel_policy="kernel")
    rng = np.random.default_rng(13)
    xs = [_keys(rng, N1) for _ in range(2)]
    later = [_keys(rng, N1) for _ in range(2)]
    config = tserve.ServiceConfig(max_batch=2, max_delay_ms=1000.0,
                                  breaker_threshold=1, max_batch_retries=0,
                                  breaker_cooldown_s=60.0)
    out, after, m, health = _served_with(
        monkeypatch, failing, spec, config, xs, then=later)
    assert all(isinstance(r, RuntimeError) for r in out), out
    for x, got in zip(later, after):
        np.testing.assert_array_equal(got, np.sort(x))
    assert m["degraded_requests"] == 2 and health["health"] == "degraded"
    assert [s.kernel_policy for s in seen] == ["kernel", "kernel"]
    assert all(s == spec for s in seen)


def test_missing_nvcc_raises_kernel_error(monkeypatch, tmp_path):
    from repro_torch.kernels import cuda

    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(cuda.KernelError, match="nvcc not found"):
        cuda._nvcc()
    assert issubclass(cuda.KernelError, RuntimeError)
