"""The fused audit, the verify policy and the imbalance SLO against the
reference, bit for bit: `fingerprint_lanes`, the audit vector and its
`AuditReport` for every algorithm at p in {1, 3, 8}, single and batched,
`RecoveryStats` under on_verify_failure raise, retry and fallback, the
SLO's tag rung, its refine rung (held to DESIGN.md Sec. 9.2) and its
ImbalanceError, the audit's collectives in the `Comm` log, and the count
word of multistage on the input where the two packages' overflow counters
differ (ROADMAP queue 3 item 10).

The reference's draws are injected; chaos plans are armed in each
package's own chaos module (`chaotic`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.chaos as rchaos
import repro.sort as rsort
import repro.sort.verify as rverify
import repro_torch.runtime.chaos as tchaos
import repro_torch.sort as tsort
import repro_torch.sort.verify as tverify
from repro_torch.core.tagging import float64_to_sortable_int64
from repro_torch.data import distributions as tdist
from repro_torch.sort import driver as tdriver
from torch_parity import (
    _run_both, assert_audit_equal, assert_audit_vec_equal,
    assert_batched_outputs_equal, assert_bits_equal,
    assert_sort_outputs_equal, chaotic, sort_batched_both, sort_both)

N = 999
ALGOS = ["hss", "sample_random", "sample_regular", "ams", "multistage"]


def _keys(n=N, seed=1, dtype=np.int32):
    return tdist.make_distribution("UNIF", n, seed=seed).astype(dtype)


def _ref_words(x: np.ndarray):
    """The reference's words of x: as they are, or float64 keys through
    the sortable int64 bijection (the words the audit hashes)."""
    if x.dtype == np.float64:
        return float64_to_sortable_int64(torch.from_numpy(x)).numpy()
    return x


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64", "float64"])
def test_fingerprint_lanes_match_reference(dtype, lanes):
    rng = np.random.default_rng(7)
    if dtype == "float64":
        x = _ref_words(rng.standard_normal((3, 1001)))
    elif dtype == "int64":
        x = rng.integers(-2 ** 63, 2 ** 63 - 1, (3, 1001), dtype=np.int64)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, (3, 1001), dtype=dtype)
    mask = rng.random((3, 1001)) < 0.7
    with jax.enable_x64(x.dtype.itemsize == 8):
        want = np.asarray(rverify.fingerprint_lanes(jnp.asarray(x), lanes))
        want_m = np.asarray(rverify.fingerprint_lanes(
            jnp.asarray(x), lanes, mask=jnp.asarray(mask)))
    t = torch.from_numpy(x.view(np.int32) if dtype == "uint32" else x)
    got = tverify.fingerprint_lanes(t, lanes, flip=False)
    got_m = tverify.fingerprint_lanes(t, lanes, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got_m.numpy(), want_m.astype(np.int64))
    # the port's uint32 encoding (top bit flipped) hashes as the reference
    if dtype == "uint32":
        flipped = torch.from_numpy((x ^ np.uint32(1 << 31)).view(np.int32))
        np.testing.assert_array_equal(
            tverify.fingerprint_lanes(flipped, lanes, flip=True).numpy(),
            want.astype(np.int64))


def _spec_kw(algo):
    # every baseline exact on the allgather exchange at these sizes
    return dict(algorithm=algo, exchange="allgather", out_slack=2.0)


# the reference's multistage cannot run on a prime p (one axis of size
# 1 fails in its stage 1: IndexError at p = 3), so it takes p = 4 there
CASES = [(algo, p) for algo in ALGOS
         for p in ((1, 4, 8) if algo == "multistage" else (1, 3, 8))]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("algo,p", CASES)
def test_audit_matches_reference(algo, p, batched):
    tier = "full" if p in (3, 4) else "cheap"
    if batched:
        xs = np.stack([_keys(seed=s) for s in range(3)])
        got, want = sort_batched_both(xs, p, tag=False, verify=tier,
                                      **_spec_kw(algo))
        assert_batched_outputs_equal(got, want)
        assert got.audit.row_ok.all()
        for b in range(3):
            assert_audit_equal(got.request(b).audit, want.request(b).audit)
    else:
        got, want = sort_both(_keys(), p, verify=tier, **_spec_kw(algo))
        assert_sort_outputs_equal(got, want)
        assert got.audit.ok
    assert_audit_equal(got.audit, want.audit)
    assert_audit_vec_equal(got, want)
    assert got.audit.count is not None


@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
def test_audit_of_other_dtypes_matches_reference(dtype):
    """uint32 keys hash the reference's uint32 words (the port flips the
    top bit of its encoding back); float32 keys their sortable int32."""
    x = np.random.default_rng(3).integers(0, 2 ** 32 - 1, N).astype(dtype)
    got, want = sort_both(x, 8, verify="full")
    assert_sort_outputs_equal(got, want)
    assert_audit_equal(got.audit, want.audit)
    assert_audit_vec_equal(got, want)


def _chaos_both(x, p, plan, batched=False, **spec_kw):
    """(port, reference) of one front-door call under a chaos plan, each
    (result or the exception raised, chaos.stats())."""
    def guard(fn):
        def run(*args):
            try:
                return fn(*args)
            except rverify.VerificationError as exc:
                return exc
            except tverify.VerificationError as exc:
                return exc
        return run

    if batched:
        ref = lambda s: rsort.sort_batched(x, s)
        port = lambda s, u: tsort.sort_batched(x, s, uniform=u)
    else:
        ref = lambda s: rsort.sort(x, s)
        port = lambda s, u: tsort.sort(x, s, uniform=u)
    (got, gs), (want, ws) = _run_both(
        chaotic(guard(ref), rchaos, plan), chaotic(guard(port), tchaos, plan),
        x.shape[-1], p, None, False, spec_kw)
    return got, gs, want, ws


@pytest.mark.parametrize("policy,corrupt_at,raises", [
    ("raise", (0,), True),
    ("retry", (0,), False),
    ("retry", (0, 1), False),
    ("fallback", (0,), False),
    ("retry", True, True),
])
def test_verify_policy_recovery_matches_reference(policy, corrupt_at,
                                                  raises):
    got, gs, want, ws = _chaos_both(_keys(), 8, dict(corrupt_at=corrupt_at),
                                    verify="cheap", on_verify_failure=policy)
    assert gs == ws
    if raises:
        assert isinstance(want, rverify.VerificationError)
        assert isinstance(got, tverify.VerificationError)
        assert str(got) == str(want)
        assert_audit_equal(got.report, want.report)
        return
    assert_sort_outputs_equal(got, want)
    assert_audit_equal(got.audit, want.audit)
    assert got.audit.ok
    np.testing.assert_array_equal(got.gather(), np.sort(_keys()))
    r = got.recovery
    assert r.verify_failures == len(corrupt_at)
    assert r.verify_fallback == (policy == "fallback" or len(corrupt_at) == 2)


def test_slo_tag_rung_holds_to_design():
    """30-bit keys with a duplicate pileup: auto tagging does not fit
    int32, so the first attempt runs untagged, as the reference's does
    with x64 off (the same bits), and misses an SLO of 1.2. The tag rung
    must meet it. The reference cannot run this rung itself (x64 off, its
    int64 packing raises; x64 on, it tags the first attempt already), so
    the rung's launch is held to the reference's tag=True sort under x64,
    and the ladder to DESIGN.md Sec. 9.2."""
    x = tdist.make_adversarial("ZIPF_HH", N, seed=11)
    kw = dict(exchange="allgather", verify="cheap", out_slack=2.0)
    first, want_first = sort_both(x, 8, **kw)
    assert_sort_outputs_equal(first, want_first)
    assert_audit_equal(first.audit, want_first.audit)
    assert first.indices is None
    assert first.recovery.achieved_imbalance > 1.2
    got, want = sort_both(x, 8, x64=True, tag=True, **kw,
                          port_overrides=dict(tag=None, imbalance_slo=1.2))
    assert got.recovery.imbalance_recovery == "tag"
    assert got.recovery.achieved_imbalance <= 1.2
    assert got.audit.ok
    with jax.enable_x64(True):
        for name in ("shards", "counts", "indices"):
            assert_bits_equal(getattr(got, name), getattr(want, name), name)
        assert_bits_equal(got.gather(), want.gather(), "gather")
    np.testing.assert_array_equal(got.gather(), np.sort(x))


def test_slo_imbalance_error_matches_reference():
    """tag=False leaves only the refine rung, and no splitter can cut one
    key class: both raise ImbalanceError with the same reading."""
    x = tdist.make_adversarial("ALL_EQUAL", N, seed=11)

    def catch(fn):
        def run(*args):
            with pytest.raises((rverify.ImbalanceError,
                                tverify.ImbalanceError)) as info:
                fn(*args)
            return info.value
        return run

    got, want = _run_both(
        catch(lambda s: rsort.sort(x, s)),
        catch(lambda s, u: tsort.sort(x, s, uniform=u)), N, 8, None, False,
        dict(tag=False, out_slack=8.0, exchange="allgather", verify="cheap",
             imbalance_slo=1.2))
    assert isinstance(got, tverify.ImbalanceError)
    assert (got.achieved, got.slo) == (want.achieved, want.slo)
    assert str(got) == str(want)


def test_slo_refine_rung_holds_to_design():
    """DESIGN.md Sec. 9.2: a starved sampler (one round of 8 samples a
    shard) misses an SLO of 1.1 on distinct-enough keys with tagging off,
    so the ladder skips the tag rung and the bonus refinement (3 rounds,
    16 samples) must meet it, pass its own audit and stamp "refine". The
    first attempt's miss is checked without the SLO."""
    x = tdist.make_distribution("UNIF", 4096, seed=0)
    kw = dict(rounds=1, sample_per_shard=8, tag=False, exchange="allgather",
              out_slack=8.0, verify="cheap")
    first, _ = sort_both(x, 8, **kw)
    assert first.recovery.achieved_imbalance > 1.1
    got, want = sort_both(x, 8, imbalance_slo=1.1, **kw)
    assert_sort_outputs_equal(got, want)
    assert_audit_equal(got.audit, want.audit)
    assert got.recovery.imbalance_recovery == "refine"
    assert got.recovery.achieved_imbalance <= 1.1
    assert got.audit.ok
    np.testing.assert_array_equal(got.gather(), np.sort(x))


def _logged(fn):
    """fn() with the Comm that `driver.run_batched` builds recorded."""
    made, real = [], tdriver.Comm

    def record(p):
        made.append(real(p))
        return made[-1]

    tdriver.Comm = record
    try:
        fn()
    finally:
        tdriver.Comm = real
    return made[-1].log


@pytest.mark.parametrize("algo,extra", [
    ("hss", {"psum": 1, "ppermute": 1}),
    ("sample_regular", {"psum": 1, "ppermute": 1}),
    ("multistage", {"psum": 1, "all_gather": 1}),
])
def test_audit_collectives_in_comm_log(algo, extra):
    """The audit adds one psum and one ppermute (multistage: one psum and
    one all_gather); a corrupt_key plan one psum more."""
    x = _keys()
    spec = tsort.SortSpec(shards=8, device="cpu", algorithm=algo)
    base = _logged(lambda: tsort.sort(x, spec))
    audited = _logged(lambda: tsort.sort(x, spec, verify="cheap"))
    assert audited - base == extra
    assert not base - audited
    def corrupted():
        with pytest.raises(tverify.VerificationError):
            tsort.sort(x, spec, verify="cheap")

    with tchaos.activate(tchaos.FaultPlan(corrupt_at=(0,),
                                          corrupt_key=int(x[0]))):
        keyed = _logged(corrupted)
    assert keyed - audited == {"psum": 1}


def test_multistage_count_word_matches_reference():
    """ROADMAP queue 3 item 10's input: 16,384 descending keys on (2, 4)
    with pair_factor 1.0. The overflow counters differ by design (the
    port sums every group), but the audit's count word, a psum over every
    shard, agrees, and both audits reject the output on count_ok."""
    x = np.arange(16_384, dtype=np.int32)[::-1].copy()
    got, gs, want, ws = _chaos_both(
        x, 8, {}, stages=(2, 4), algorithm="multistage", pair_factor=1.0,
        verify="cheap")
    assert isinstance(want, rverify.VerificationError)
    assert isinstance(got, tverify.VerificationError)
    assert_audit_equal(got.report, want.report)
    assert not got.report.count_ok
    assert got.report.count == want.report.count < 16_384
