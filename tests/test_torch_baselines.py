"""The paper's baselines against the reference, bit for bit: random- and
regular-sampling sample sort and AMS through `sort`, `sort_batched`
and `argsort` (shards, counts, splitter keys and ranks, overflow and
n_satisfied), sample_random's lossy default sizing held to the
reference's result rather than to np.sort, AMS's scan failure, the retry
and spill policies on every baseline, and each splitter phase's collective log
against the reference's registered contract. The reference's draws are
injected (one unsplit draw of each shard key for sample_random and ams).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.contracts import get_contract
from repro_torch.core import ams as tams
from repro_torch.core import sample_sort as tss
from repro_torch.data import distributions as tdist
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm
from torch_parity import (
    argsort_both, assert_batched_outputs_equal, assert_bits_equal,
    assert_sort_outputs_equal, random_keys, sort_batched_both, sort_both)

rams = importlib.import_module("repro.core.ams")
rss = importlib.import_module("repro.core.sample_sort")

BASELINES = ["sample_random", "sample_regular", "ams"]
N_LOCAL = 2048
#: (p, dtype): every shard count with each key dtype among them.
CASES = [(2, np.int32), (3, np.uint32), (4, np.float32), (8, np.int32)]


@pytest.mark.parametrize("p,dtype", CASES)
@pytest.mark.parametrize("algorithm", BASELINES)
def test_sort_matches_reference(algorithm, p, dtype):
    x = random_keys(dtype, p * N_LOCAL + 3, seed=p)
    got, want = sort_both(x, p, algorithm=algorithm, tag=False)
    assert_sort_outputs_equal(got, want)
    if algorithm == "ams":
        assert int(got.stats.n_satisfied[0]) in (0, p - 1)


@pytest.mark.parametrize("policy", ["auto", "kernel"])
@pytest.mark.parametrize("algorithm", BASELINES)
def test_sort_batched_matches_reference(algorithm, policy):
    """The port's kernel policy (the kernels' plain versions here) against
    the reference's default: every policy gives the same bits."""
    xs = random_keys(np.int32, (3, 4 * N_LOCAL), seed=11)
    got, want = sort_batched_both(xs, 4, {"kernel_policy": policy},
                                  algorithm=algorithm, tag=False)
    assert_batched_outputs_equal(got, want)
    for b in range(3):     # the shared sample mask: row b is sort() of it
        one, _ = sort_both(xs[b], 4, algorithm=algorithm, tag=False)
        view = got.request(b)
        for name in ("shards", "counts", "splitter_keys", "overflow"):
            assert_bits_equal(getattr(view, name), getattr(one, name), name)


@pytest.mark.parametrize("algorithm", BASELINES)
def test_argsort_matches_reference(algorithm):
    x = tdist.make_distribution("SKEW2", 4099, seed=1)
    got, want = argsort_both(x, 4, algorithm=algorithm)
    assert_bits_equal(got, want, "argsort")
    np.testing.assert_array_equal(got, np.argsort(x, kind="stable"))


def test_sample_random_default_sizing_is_lossy_like_the_reference():
    """At p = 8 and 16,384 keys the default sample leaves the splitting
    past its eps: the exchange truncates in both packages alike."""
    x = np.random.default_rng(0).permutation(8 * N_LOCAL).astype(np.int32)
    got, want = sort_both(x, 8, algorithm="sample_random", tag=False)
    assert_sort_outputs_equal(got, want)
    assert int(got.overflow) > 0
    assert got.gather().shape[0] < x.shape[0]


@pytest.mark.parametrize("policy", ["retry", "spill"])
@pytest.mark.parametrize("algorithm", BASELINES)
def test_recovery_matches_reference(algorithm, policy):
    """Descending keys overflow the dense pair caps under every baseline:
    retry escalates (RecoveryStats equal) and spill ends exact."""
    x = tdist.make_adversarial("REVERSE", 8 * N_LOCAL, seed=0)
    got, want = sort_both(x, 8, algorithm=algorithm, tag=False,
                          on_overflow=policy)
    assert_sort_outputs_equal(got, want)
    np.testing.assert_array_equal(got.gather(), np.sort(x))
    if policy == "retry":
        assert got.recovery.attempts > 1


def test_ams_scan_failure_matches_reference():
    """A sample far too small to advance (tests/test_baselines.py:46-53):
    the scan reports failure, n_satisfied 0, in both packages."""
    x = np.random.default_rng(0).permutation(8 * N_LOCAL).astype(np.int32)
    got, want = sort_both(x, 8, algorithm="ams", eps=0.01, total_sample=8,
                          out_slack=8.0, tag=False)
    assert_sort_outputs_equal(got, want)
    assert int(got.stats.n_satisfied[0]) == 0


@pytest.mark.parametrize("eps", [0.05, 0.5])
def test_scanning_splitters_match_reference(rng, eps):
    """The scan alone on ranked probe rows, against the reference's."""
    p, n = 8, 10_000
    for _ in range(3):
        ranks = np.sort(rng.integers(0, n + 1, (2, 40))).astype(np.int32)
        probes = np.sort(rng.integers(-100, 100, (2, 40))).astype(np.int32)
        keys, kranks, ok = tams.scanning_splitters(
            torch.from_numpy(probes), torch.from_numpy(ranks), p=p, n=n,
            eps=eps)
        for b in range(2):
            want = rams.scanning_splitters(jnp.asarray(probes[b]),
                                           jnp.asarray(ranks[b]), p=p,
                                           n=n, eps=eps)
            for got_b, want_b, name in zip((keys[b], kranks[b], ok[b]), want,
                                           ("keys", "ranks", "ok")):
                assert_bits_equal(got_b, np.asarray(want_b), name)


def test_sample_sizes_match_reference():
    for p in (2, 3, 8, 64):
        for eps in (0.01, 0.05, 0.2):
            assert tss.default_regular_s(p, eps) == rss.default_regular_s(
                p, eps)
            for n_local in (1, 1000, 2_000_000):
                assert tss.default_total_sample(p, n_local, eps) == \
                    rss.default_total_sample(p, n_local, eps)
                assert tams.ams_sample_size(p, eps, n_local * p) == \
                    rams.ams_sample_size(p, eps, n_local * p)


@pytest.mark.parametrize("algorithm", BASELINES)
def test_splitter_collectives_match_the_contract(algorithm):
    """One splitter phase of B = 3 requests makes the reference's
    registered calls, once whatever B is."""
    p = 4
    rows = dispatch.local_sort(torch.from_numpy(
        random_keys(np.int32, (p, 3, 512), seed=3)))
    u = torch.rand((p, 512), generator=torch.Generator().manual_seed(0))
    comm = Comm(p)
    if algorithm == "sample_random":
        tss.random_sample_splitters(rows, comm=comm, total_sample=200, u=u)
    elif algorithm == "sample_regular":
        tss.regular_sample_splitters(rows, comm=comm, s=16)
    else:
        tams.ams_splitters(rows, comm=comm, eps=0.05, u=u)
    want = get_contract(f"splitters:{algorithm}").total_counts
    assert {k: comm.log[k] for k in want} == want
    assert set(comm.log) <= set(want)
