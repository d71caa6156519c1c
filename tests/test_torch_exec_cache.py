"""The shard-program cache and the serving keys against the reference:
`ExecutableCache` (hits, misses, evictions, LRU order, stats, clear)
under one key sequence; `spec_fingerprint` and `bucket_key` giving the
same equivalence classes over a grid of specs that differ in one field
each; and the cache's counters moving alike around the front doors: a
warm second call is a hit the reference would not trace (`traces`
still; the port keeps keys only and builds every launch's program), a
corrupted launch and the warm-started attempts of the retry policy stay
out of the cache.

The port's unbatched `sort` is its batched engine at B = 1, so it shares
the cache line of a (1, n) `sort_batched` (the reference keys them
apart, "single" and "batched"); the comparisons here never mix the two.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.runtime.chaos as rchaos
import repro.sort as rsort
import repro.sort.driver as rdriver
import repro.sort.verify as rverify
import repro_torch.runtime.chaos as tchaos
import repro_torch.sort as tsort
import repro_torch.sort.driver as tdriver
import repro_torch.sort.verify as tverify
from repro.sort import SortSpec as RefSortSpec
from repro_torch.data import distributions as tdist
from torch_parity import (
    _run_both, assert_sort_outputs_equal, auto_mesh, auto_mesh2d,
    port_spec)

KEYS = ["a", "b", "a", "c", "d", "b", "a", "a", "e", "c", "f", "b"]


def _drive_cache(mod):
    built, seen = [], []
    cache = mod.ExecutableCache(max_entries=3)
    for k in KEYS:
        got = cache.get_or_build(k, lambda k=k: built.append(k) or k.upper())
        seen.append((got, [cache.contains(x) for x in "abcdef"],
                     cache.stats(), len(cache)))
    seen.append(cache.get_or_build(None, lambda: "uncached"))
    seen.append(cache.stats())
    cache.clear()
    seen.append(cache.stats())
    return built, seen


def test_cache_lru_matches_reference():
    (got_built, got), (want_built, want) = (_drive_cache(tdriver),
                                            _drive_cache(rdriver))
    assert got == want
    s = got[len(KEYS) - 1][2]
    assert (s["hits"], s["misses"], s["evictions"]) == (2, 10, 7)
    # the port records keys only: every call builds, where the reference
    # builds on a miss
    assert got_built == KEYS and len(want_built) == s["misses"]


def test_every_launch_builds_its_program():
    """A hit counts, and the shard program is built all the same: the
    cache holds no program that a later launch could be served from."""
    builds = []
    cache = tdriver.exec_cache
    cache.clear()
    try:
        for key in ("k1", "k1", None, "k2", "k1"):
            got = tdriver.shard_program(
                key, lambda key=key: builds.append(key) or len(builds), 8)
            assert got == len(builds)
        assert builds == ["k1", "k1", None, "k2", "k1"]
        s = cache.stats()
        assert (s["hits"], s["misses"], s["traces"], s["size"]) == (2, 2, 3,
                                                                     2)
        assert tdriver.shard_program("k3", builds.append, 1) is None
        assert cache.stats() == s and len(builds) == 5
    finally:
        cache.clear()


def test_exports():
    assert tsort.exec_cache is tdriver.exec_cache
    assert isinstance(tsort.exec_cache, tdriver.ExecutableCache)
    assert tsort.bucket_key is not None and tsort.spec_fingerprint


# one field changed a step: (field, value); "mesh" is the reference's
# mesh (the port's shards and stages)
VARIANTS = [
    ("algorithm", "ams"), ("eps", 0.1), ("rounds", 3),
    ("sample_per_shard", 16), ("adaptive", False), ("total_sample", 100),
    ("s", 5), ("exchange", "allgather"), ("exchange", "dense_spill"),
    ("exchange", "ragged"), ("pair_factor", 2.0), ("out_slack", 1.5),
    ("on_overflow", "retry"), ("on_overflow", "spill"),
    ("max_overflow_retries", 5), ("capacity_scale", 2.0),
    ("verify", "cheap"), ("on_verify_failure", "retry"),
    ("imbalance_slo", 1.2), ("semisort_sample", 32),
    ("heavy_fraction", 0.25), ("stable", True), ("tag", False),
    ("tag", True), ("seed", 3), ("kernel_policy", "xla"),
    ("kernel_policy", "pallas"), ("batch", True),
    ("initial_probes", np.arange(7, dtype=np.int32)),
    ("mesh", "p4"), ("mesh", "grid"),
]


def _both_specs(field, value):
    base = RefSortSpec(mesh=auto_mesh(8))
    if field == "mesh":
        value = auto_mesh(4) if value == "p4" else auto_mesh2d(2, 4)
    var = dataclasses.replace(base, **{field: value})
    p = var.mesh.devices.size
    return (base, var), (port_spec(base, 8), port_spec(var, p))


@pytest.mark.parametrize("field,value", VARIANTS,
                         ids=[f"{f}={v}" if not isinstance(v, np.ndarray)
                              else f for f, v in VARIANTS])
def test_spec_fingerprint_classes_match_reference(field, value):
    (rb, rv), (tb, tv) = _both_specs(field, value)
    rfb, rfv = rsort.spec_fingerprint(rb), rsort.spec_fingerprint(rv)
    tfb, tfv = tsort.spec_fingerprint(tb), tsort.spec_fingerprint(tv)
    assert (tfv is None) == (rfv is None)
    assert (tfb == tfv) == (rfb == rfv)
    hash(tfb)
    rk = [rsort.bucket_key(256, np.int32, s) for s in (rb, rv)]
    tk = [tsort.bucket_key(256, np.int32, s) for s in (tb, tv)]
    assert (tk[0] == tk[1]) == (rk[0] == rk[1])


BUCKETS = [(256, np.int32, "sort", None), (384, np.int32, "sort", None),
           (256, np.float32, "sort", None), (256, np.uint32, "sort", None),
           (256, np.int64, "sort", None), (256, np.float64, "sort", None),
           (256, np.int32, "argsort", None), (256, np.int32, "sort_kv", None),
           (256, np.int32, "semisort", None), (256, np.int32, "top_k", 8),
           (256, np.int32, "top_k", 16), (256.0, "int32", "sort", None)]


def test_bucket_key_classes_match_reference():
    rspec = RefSortSpec(mesh=auto_mesh(8))
    tspec = port_spec(rspec, 8)
    rk = [rsort.bucket_key(n, d, rspec, kind=k, param=q)
          for n, d, k, q in BUCKETS]
    tk = [tsort.bucket_key(n, d, tspec, kind=k, param=q)
          for n, d, k, q in BUCKETS]
    for i in range(len(BUCKETS)):
        assert tk[i][:3] == rk[i][:3]
        assert len(tk[i]) == len(rk[i])
        for j in range(len(BUCKETS)):
            assert (tk[i] == tk[j]) == (rk[i] == rk[j])
    # a torch dtype reads as NumPy's name
    assert tsort.bucket_key(256, torch.float32, tspec) == tk[2]
    # opaque specs bucket by identity
    probes = dataclasses.replace(tspec, initial_probes=np.arange(7))
    assert tsort.bucket_key(256, np.int32, probes)[3] == ("opaque",
                                                         id(probes))


def _delta(cache, fn):
    """fn() and how it moved the cache: (hits, misses, size, traces)."""
    s0 = cache.stats()
    try:
        out = fn()
    except (rverify.VerificationError, tverify.VerificationError) as e:
        out = e
    s1 = cache.stats()
    return out, tuple(s1[k] - s0[k]
                      for k in ("hits", "misses", "size", "traces"))


def _both_deltas(ref, port, n, p, chaos_plan=None, **spec_kw):
    """(port delta, reference delta, port out, reference out) of one
    front-door call on each package, the reference's draws injected."""
    moved = {}

    def ref_fn(s):
        run = lambda: ref(s)
        if chaos_plan is not None:
            with rchaos.activate(rchaos.FaultPlan(**chaos_plan)):
                out, moved["ref"] = _delta(rdriver.exec_cache, run)
        else:
            out, moved["ref"] = _delta(rdriver.exec_cache, run)
        return out

    def port_fn(s, u):
        run = lambda: port(s, u)
        if chaos_plan is not None:
            with tchaos.activate(tchaos.FaultPlan(**chaos_plan)):
                out, moved["port"] = _delta(tdriver.exec_cache, run)
        else:
            out, moved["port"] = _delta(tdriver.exec_cache, run)
        return out

    got, want = _run_both(ref_fn, port_fn, n, p, None, False, spec_kw)
    return moved["port"], moved["ref"], got, want


def test_warm_second_call_is_a_hit_without_a_build():
    x = tdist.make_distribution("UNIF", 1237, seed=4)
    ref = lambda s: rsort.sort(x, s)
    port = lambda s, u: tsort.sort(x, s, uniform=u)
    first = _both_deltas(ref, port, x.shape[0], 8, tag=False)
    assert first[0] == first[1] == (0, 1, 1, 1)
    second = _both_deltas(ref, port, x.shape[0], 8, tag=False)
    assert second[0] == second[1] == (1, 0, 0, 0)
    assert_sort_outputs_equal(second[2], second[3])
    # another seed is another request of the same program: a hit
    third = _both_deltas(ref, port, x.shape[0], 8, tag=False, seed=5)
    assert third[0] == third[1] == (1, 0, 0, 0)


def test_batched_and_grouping_lines_match_reference():
    xs = np.stack([tdist.make_distribution("UNIF", 1241, seed=s)
                   for s in range(3)])
    calls = [
        (lambda s: rsort.sort_batched(xs, s),
         lambda s, u: tsort.sort_batched(xs, s, uniform=u)),
        (lambda s: rsort.semisort_batched(xs, s),
         lambda s, u: tsort.semisort_batched(xs, s, uniform=u)),
        (lambda s: rsort.top_k_batched(xs, 16, s),
         lambda s, u: tsort.top_k_batched(xs, 16, s)),
    ]
    for ref, port in calls:
        cold = _both_deltas(ref, port, xs.shape[1], 8, tag=False)
        warm = _both_deltas(ref, port, xs.shape[1], 8, tag=False)
        assert cold[0] == cold[1] and cold[0][:3] == (0, 1, 1)
        assert warm[0] == warm[1] == (1, 0, 0, 0)


def test_corrupted_launch_stays_out_of_the_cache():
    """corrupt_at=True under verify="cheap": the launch is built for
    itself and cached nowhere, in both packages; the clean line of the
    same shape is then a miss."""
    x = tdist.make_distribution("UNIF", 1249, seed=6)
    ref = lambda s: rsort.sort(x, s)
    port = lambda s, u: tsort.sort(x, s, uniform=u)
    kw = dict(verify="cheap", exchange="allgather", tag=False)
    got, want, gout, wout = _both_deltas(ref, port, x.shape[0], 8,
                                         chaos_plan=dict(corrupt_at=True),
                                         **kw)
    assert isinstance(gout, tverify.VerificationError)
    assert isinstance(wout, rverify.VerificationError)
    assert got == want == (0, 0, 0, 1)
    clean = _both_deltas(ref, port, x.shape[0], 8, **kw)
    assert clean[0] == clean[1] == (0, 1, 1, 1)


def test_warm_started_retries_stay_out_of_the_cache():
    """A clamp of 16 keys a pair overflows; the retry policy's attempts
    carry warm-start probes, so only the first launch touches the cache
    and each attempt builds its own program, in both packages."""
    x = tdist.make_distribution("UNIF", 1259, seed=7)
    ref = lambda s: rsort.sort(x, s)
    port = lambda s, u: tsort.sort(x, s, uniform=u)
    got, want, gout, wout = _both_deltas(
        ref, port, x.shape[0], 8, chaos_plan=dict(clamp_pair_cap=16),
        on_overflow="retry", tag=False)
    assert gout.recovery.attempts == wout.recovery.attempts > 1
    assert got == want
    assert got[:3] == (0, 1, 1) and got[3] == gout.recovery.attempts
