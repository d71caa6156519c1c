"""The chaos seams against the reference: `FaultPlan`, `activate`,
`corrupt_now`, `clamp_pair_cap`, `trace_token`, `on_dispatch` and
`stats()` over the same call sequence in both modules; the exchange's
clamp (`ExchangeConfig.pair_cap`, and `out_extra` in `out_cap`); the
clamp under on_overflow="retry", with RecoveryStats equal to the
reference's; and injected corruption on every algorithm, single and
batched (`corrupt_at`, `corrupt_key`), caught by both audits alike.
"""
import numpy as np
import pytest

import repro.runtime.chaos as rchaos
import repro.sort as rsort
import repro.sort.verify as rverify
import repro_torch.runtime as truntime
import repro_torch.runtime.chaos as tchaos
import repro_torch.sort as tsort
import repro_torch.sort.verify as tverify
from repro.core.exchange import ExchangeConfig as RefExchangeConfig
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.data import distributions as tdist
from torch_parity import (
    _run_both, assert_audit_equal, assert_batched_outputs_equal,
    assert_recovery_equal, assert_sort_outputs_equal, chaotic)

N = 999
ALGOS = ["hss", "sample_random", "sample_regular", "ams", "multistage"]


def _calls(chaos):
    """One call sequence through every seam; -> what each call returned
    or raised, and stats() after each."""
    seen = []

    def note(fn, *args):
        try:
            seen.append(("ok", fn(*args)))
        except (chaos.InjectedFault, chaos.ExecutorDeath) as exc:
            seen.append((type(exc).__name__, str(exc)))
        seen.append(("stats", chaos.stats()))

    for _ in range(4):
        note(chaos.corrupt_now)
    note(chaos.clamp_pair_cap, 100)
    note(chaos.clamp_pair_cap, 3)
    note(chaos.trace_token)
    for i in range(5):
        note(chaos.on_dispatch, np.arange(4) + i)
    note(chaos.on_dispatch, None)
    return seen


PLANS = [
    dict(),
    dict(corrupt_at=(1, 3), corrupt_key=7, corrupt_bit=3),
    dict(corrupt_at=True, clamp_pair_cap=16),
    dict(straggler_at=(0,), straggler_delay_s=0.001, crash_at=(1,),
         die_at=(3,), poison_key=6),
]


@pytest.mark.parametrize("plan", PLANS, ids=["empty", "corrupt", "always",
                                             "dispatch"])
def test_fault_plan_and_stats_match_reference(plan):
    assert tchaos.active() is None and tchaos.stats() == {}
    assert tchaos.corrupt_now() is None and tchaos.on_dispatch() == -1
    assert tchaos.clamp_pair_cap(5) == 5 and tchaos.trace_token() is None
    with rchaos.activate(rchaos.FaultPlan(**plan)):
        want = _calls(rchaos)
    with tchaos.activate(tchaos.FaultPlan(**plan)) as state:
        assert tchaos.active() == tchaos.FaultPlan(**plan)
        with pytest.raises(RuntimeError, match="already active"):
            with tchaos.activate(tchaos.FaultPlan()):
                pass
        got = _calls(tchaos)
        assert state.plan is tchaos.active()
    assert got == want
    assert tchaos.active() is None


def test_runtime_package_is_lazy():
    assert truntime.FaultPlan is tchaos.FaultPlan
    assert truntime.chaos is tchaos
    assert issubclass(truntime.InjectedFault, RuntimeError)
    assert not issubclass(truntime.ExecutorDeath, Exception)
    assert truntime.StepTimer.__module__ == "repro_torch.runtime.ft"
    assert truntime.TrainSupervisor.__module__ == "repro_torch.runtime.ft"
    assert sorted(truntime.__all__) == sorted(
        __import__("repro.runtime", fromlist=["__all__"]).__all__)


@pytest.mark.parametrize("clamp", [None, 8, 40, 10_000])
def test_exchange_capacities_match_reference(clamp):
    """pair_cap clamps the base before capacity_scale; out_extra adds to
    out_cap."""
    plan = dict(clamp_pair_cap=clamp)
    for kw in (dict(), dict(capacity_scale=4.0, pair_factor=1.5),
               dict(out_extra=77, out_slack=2.0)):
        ref, port = RefExchangeConfig(**kw), ExchangeConfig(**kw)
        with rchaos.activate(rchaos.FaultPlan(**plan)):
            want = [(ref.pair_cap(n, p), ref.out_cap(n, p, 0.05))
                    for n, p in ((1000, 8), (125, 3), (7, 2))]
        with tchaos.activate(tchaos.FaultPlan(**plan)):
            got = [(port.pair_cap(n, p), port.out_cap(n, p, 0.05))
                   for n, p in ((1000, 8), (125, 3), (7, 2))]
        assert got == want


@pytest.mark.parametrize("batched", [False, True])
def test_clamp_under_retry_matches_reference(batched):
    """A clamp of 64 keys a pair overflows the dense exchange; the retry
    policy escalates past it. Keys, counts and RecoveryStats equal the
    reference's; chaos.stats() too, `clamp_traces` included: both count
    the cache keys their front doors derive under the clamp."""
    plan = dict(clamp_pair_cap=64)
    x = tdist.make_distribution("UNIF", 8192, seed=1)
    if batched:
        x = np.stack([x[:4096], x[4096:]])
        ref = lambda s: rsort.sort_batched(x, s)
        port = lambda s, u: tsort.sort_batched(x, s, uniform=u)
    else:
        ref = lambda s: rsort.sort(x, s)
        port = lambda s, u: tsort.sort(x, s, uniform=u)
    (got, gs), (want, ws) = _run_both(
        chaotic(ref, rchaos, plan), chaotic(port, tchaos, plan),
        x.shape[-1], 8, None, False,
        dict(on_overflow="retry", tag=False))
    if batched:
        assert_batched_outputs_equal(got, want)
    else:
        assert_sort_outputs_equal(got, want)
    assert_recovery_equal(got.recovery, want.recovery)
    assert got.recovery.attempts > 1 and got.recovery.recovered_overflow > 0
    assert gs == ws


def _guarded(fn):
    def run(*args):
        try:
            return fn(*args)
        except (rverify.VerificationError, tverify.VerificationError) as e:
            return e
    return run


@pytest.mark.parametrize("p", [3, 8])
@pytest.mark.parametrize("algo", ALGOS)
def test_corruption_is_caught_like_reference(algo, p):
    """corrupt_at=(0,) under "raise": both audits reject the output with
    the same report and message (multistage on (2, 2) where the others
    take p = 3: the reference's multistage fails on a prime p)."""
    x = tdist.make_distribution("UNIF", N, seed=2)
    stages = {}
    if algo == "multistage":
        p = 4 if p == 3 else p
        stages = dict(stages=(2, p // 2))
    plan = dict(corrupt_at=(0,))
    (got, gs), (want, ws) = _run_both(
        chaotic(_guarded(lambda s: rsort.sort(x, s)), rchaos, plan),
        chaotic(_guarded(lambda s, u: tsort.sort(x, s, uniform=u)), tchaos,
                plan),
        N, p, None, False, dict(algorithm=algo, exchange="allgather",
                                out_slack=2.0, verify="cheap", **stages))
    assert isinstance(want, rverify.VerificationError)
    assert type(got) is tverify.VerificationError
    assert str(got) == str(want)
    assert_audit_equal(got.report, want.report)
    assert not got.report.fingerprint_ok
    assert gs == ws


@pytest.mark.parametrize("p", [3, 8])
@pytest.mark.parametrize("algo", ALGOS)
def test_corrupt_key_fails_one_row_like_reference(algo, p):
    """corrupt_key present in one row of a batch: BatchVerificationError
    with row_ok false at that row alone, the same report as the
    reference's, and the other rows' gathers equal to np.sort."""
    xs = np.stack([tdist.make_distribution("UNIF", N, seed=s)
                   for s in range(3)])
    key = int(xs[1, 17])
    assert not (xs[[0, 2]] == key).any()
    stages = {}
    if algo == "multistage":
        p = 4 if p == 3 else p
        stages = dict(stages=(2, p // 2))
    plan = dict(corrupt_at=True, corrupt_key=key)
    (got, gs), (want, ws) = _run_both(
        chaotic(_guarded(lambda s: rsort.sort_batched(xs, s)), rchaos, plan),
        chaotic(_guarded(lambda s, u: tsort.sort_batched(xs, s, uniform=u)),
                tchaos, plan),
        N, p, None, False, dict(algorithm=algo, exchange="allgather",
                                out_slack=2.0, tag=False, verify="cheap",
                                **stages))
    assert isinstance(want, rverify.BatchVerificationError)
    assert type(got) is tverify.BatchVerificationError
    np.testing.assert_array_equal(got.row_ok, [True, False, True])
    np.testing.assert_array_equal(got.row_ok, want.row_ok)
    assert_audit_equal(got.report, want.report)
    for b in (0, 2):
        np.testing.assert_array_equal(got.output.gather(b), np.sort(xs[b]))
        np.testing.assert_array_equal(got.output.gather(b),
                                      want.output.gather(b))
    assert gs == ws
