"""The port's serving drills on the CPU (repro_torch.serve.smoke: the
steady state over HTTP, the fault drill and the audit drill through
`ServiceRunner.submit`, the latter at the reference's breaker cooldown
and a longer one), and the chaos counters of one served batch against the
reference service's: the clamp's `clamp_traces` (one a bucket key at
admission, one a cache key per cached launch), the dispatch index, the
injected crash and death.
"""
import asyncio

import numpy as np
import pytest

import repro.runtime.chaos as rchaos
import repro.serve as rserve
import repro_torch.runtime.chaos as tchaos
import repro_torch.serve as tserve
from repro.sort import SortSpec as RefSortSpec
from repro_torch.serve import smoke
from repro_torch.sort import SortSpec
from torch_parity import auto_mesh


def test_steady_state_drill():
    out = smoke.main(device="cpu")
    assert out["hit_rate"] > 0.9 and out["metrics"]["served"] == smoke.LOAD
    assert 429 in out["codes"] and 200 in out["codes"]


def test_chaos_drill():
    out = smoke.chaos_main(device="cpu")
    assert out["executor"]["restarts"] >= 1
    assert out["chaos"]["crash"] == out["chaos"]["death"] == 1
    assert out["metrics"]["health"]["health"] == "ok"


@pytest.mark.parametrize("cooldown_s", [0.5, 2.0])
def test_corrupt_drill(cooldown_s):
    out = smoke.corrupt_main(device="cpu", cooldown_s=cooldown_s)
    assert out["clean_hits"] > 0 and out["clean_misses"] == 0
    assert out["metrics"]["degraded_requests"] >= 1
    assert out["metrics"]["degraded_errors"] == 0


def _served_under_plan(mod, chaos, spec, xs, plan):
    """Four requests, one full batch, under `plan`: -> (results,
    chaos.stats(), the metrics snapshot)."""
    config = mod.ServiceConfig(max_batch=4, max_delay_ms=1000.0,
                               retry_backoff_s=0.001)

    async def run():
        async with mod.SortService(spec=spec, config=config) as svc:
            futs = [svc.enqueue(x) for x in xs]
            out = await asyncio.gather(*futs, return_exceptions=True)
            return out, chaos.stats(), svc.metrics.snapshot()
    with chaos.activate(chaos.FaultPlan(**plan)):
        return asyncio.run(run())


def test_clamp_traces_and_dispatch_faults_match_reference():
    rng = np.random.default_rng(11)
    xs = [rng.permutation(4 * 2048)[:2048].astype(np.int32)
          for _ in range(4)]
    plan = dict(clamp_pair_cap=16, crash_at=(0,), die_at=(1,))
    got, gstats, gm = _served_under_plan(
        tserve, tchaos, SortSpec(exchange="dense", on_overflow="retry",
                                 tag=False, shards=8, device="cpu"), xs, plan)
    want, wstats, wm = _served_under_plan(
        rserve, rchaos, RefSortSpec(exchange="dense", on_overflow="retry",
                                    tag=False, mesh=auto_mesh(8)), xs, plan)
    for x, g, w in zip(xs, got, want):
        np.testing.assert_array_equal(g, np.sort(x))
        np.testing.assert_array_equal(g, w)
    assert gstats == wstats
    assert gstats["clamp_traces"] == 5 and gstats["dispatches"] == 3
    for k in ("batch_retries", "executor_restarts", "bisections", "errors",
              "served"):
        assert gm[k] == wm[k], k
    assert gm["overflow_retries"] >= 1 and wm["overflow_retries"] >= 1
