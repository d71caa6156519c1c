"""The legacy entry points against the reference's, bit for bit:
`hss_sort` and `gather_sorted`, `sample_sort` (random, regular),
`ams_sort` and `two_stage_sort` at p in {3, 8} (multistage at p = 4: the
reference's multistage fails on a prime p, ROADMAP queue 3 item 11),
`pack_tagged`/`unpack_tagged` at 31 and 63 total bits (the reference's
int64 case under jax x64), `probe_counts` against the reference's
interpret-mode kernel and `merge_flat_runs`. The reference runs on the
Auto mesh of `torch_parity` with its own draws injected into the port.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.common import HSSConfig as RefHSSConfig
from repro.sort import SortSpec as RefSortSpec
from repro_torch.core import ams as tams
from repro_torch.core import hss as thss
from repro_torch.core import multistage as tms
from repro_torch.core import sample_sort as tss
from repro_torch.core import tagging as ttag
from repro_torch.core.common import HSSConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.histogram import ops as thops
from repro_torch.kernels.merge import ops as tmops
from repro_torch.sort import driver as tdriver
from torch_parity import (
    assert_bits_equal, assert_stats_equal, auto_mesh, auto_mesh2d,
    random_keys, reference_draws, to_numpy)

rhss = importlib.import_module("repro.core.hss")
rss = importlib.import_module("repro.core.sample_sort")
rams = importlib.import_module("repro.core.ams")
rms = importlib.import_module("repro.core.multistage")
rtag = importlib.import_module("repro.core.tagging")
rhops = importlib.import_module("repro.kernels.histogram.ops")
rmops = importlib.import_module("repro.kernels.merge.ops")

N_LOCAL = 1024


def _draws(algorithm, p, n, seed, mesh=None):
    spec = RefSortSpec(algorithm=algorithm, seed=seed, mesh=mesh)
    return reference_draws(spec, p, n)


def assert_results_equal(got, want):
    """A port SortResult against the reference's, field by field."""
    for name in ("shards", "splitter_keys"):
        assert_bits_equal(getattr(got, name), getattr(want, name), name)
    for name in ("counts", "splitter_ranks", "overflow"):
        assert_bits_equal(getattr(got, name), getattr(want, name), name)
    assert_stats_equal(got.stats, want.stats)
    assert_bits_equal(thss.gather_sorted(got), rhss.gather_sorted(want),
                      "gather_sorted")


@pytest.mark.parametrize("p", [3, 8])
def test_hss_sort_matches_reference(p):
    x = random_keys(np.int32, p * N_LOCAL + 5, seed=p)
    want = rhss.hss_sort(jnp.asarray(x), mesh=auto_mesh(p), seed=3)
    got = thss.hss_sort(x, shards=p, seed=3, device="cpu",
                        uniform=_draws("hss", p, x.shape[0], 3))
    assert_results_equal(got, want)
    np.testing.assert_array_equal(thss.gather_sorted(got), np.sort(x))


def test_hss_sort_warm_start_and_configs_match_reference():
    """Warm-start probes, a fixed round count and the kernel policy."""
    p = 8
    x = random_keys(np.int32, p * N_LOCAL, seed=21)
    probes = np.sort(x[::997])
    want = rhss.hss_sort(jnp.asarray(x), mesh=auto_mesh(p), seed=1,
                         hss_cfg=RefHSSConfig(rounds=3),
                         initial_probes=jnp.asarray(probes))
    got = thss.hss_sort(x, shards=p, seed=1,
                        hss_cfg=HSSConfig(rounds=3, kernel_policy="kernel"),
                        initial_probes=probes, device="cpu",
                        uniform=_draws("hss", p, x.shape[0], 1))
    assert_results_equal(got, want)


@pytest.mark.parametrize("p", [3, 8])
@pytest.mark.parametrize("method", ["random", "regular"])
def test_sample_sort_matches_reference(method, p):
    x = random_keys(np.int32, p * N_LOCAL + 1, seed=p + 7)
    want = rss.sample_sort(jnp.asarray(x), mesh=auto_mesh(p), method=method,
                           seed=2)
    got = tss.sample_sort(x, shards=p, method=method, seed=2, device="cpu",
                          uniform=_draws("sample_random", p, x.shape[0], 2))
    assert_results_equal(got, want)


@pytest.mark.parametrize("p", [3, 8])
def test_ams_sort_matches_reference(p):
    x = random_keys(np.int32, p * N_LOCAL, seed=p + 11)
    want = rams.ams_sort(jnp.asarray(x), mesh=auto_mesh(p), seed=4)
    got = tams.ams_sort(x, shards=p, seed=4, device="cpu",
                        uniform=_draws("ams", p, x.shape[0], 4))
    assert_results_equal(got, want)
    assert int(got.stats.n_satisfied[0]) in (0, p - 1)


@pytest.mark.parametrize("stages", [(2, 2), (2, 4)])
def test_two_stage_sort_matches_reference(stages):
    r1, r2 = stages
    p = r1 * r2
    x = random_keys(np.int32, p * N_LOCAL, seed=p + 13)
    mesh = auto_mesh2d(r1, r2)
    want = rms.two_stage_sort(jnp.asarray(x), mesh, seed=5)
    got = tms.two_stage_sort(x, stages, seed=5, shards=p, device="cpu",
                             uniform=_draws("multistage", p, x.shape[0], 5,
                                            mesh))
    for g, w, name in zip(got, want, ("shards", "counts", "overflow")):
        assert_bits_equal(g, w, name)
    out, counts, _ = got
    np.testing.assert_array_equal(
        tdriver.masked_concat(out.reshape(p, -1), counts.reshape(p)),
        np.sort(x))


def test_legacy_entry_points_equal_the_front_door():
    """Each shim equals `sort` with the same algorithm, seed and draws."""
    import repro_torch.sort as tsort

    p = 8
    x = random_keys(np.int32, p * N_LOCAL, seed=31)
    spec = tsort.SortSpec(shards=p, device="cpu", tag=False)
    calls = {
        "hss": lambda u: thss.hss_sort(x, shards=p, device="cpu", uniform=u),
        "sample_random": lambda u: tss.sample_sort(
            x, shards=p, device="cpu", uniform=u),
        "sample_regular": lambda u: tss.sample_sort(
            x, shards=p, method="regular", device="cpu", uniform=u),
        "ams": lambda u: tams.ams_sort(x, shards=p, device="cpu", uniform=u),
    }
    for algo, call in calls.items():
        u = _draws(algo, p, x.shape[0], 0)
        got = call(u)
        front = tsort.sort(x, spec, algorithm=algo, uniform=u)
        assert_bits_equal(got.shards, front.shards, algo)
        assert_bits_equal(thss.gather_sorted(got), front.gather(), algo)


def test_legacy_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = np.arange(64, dtype=np.int32)
    for call in (lambda: thss.hss_sort(x),
                 lambda: tss.sample_sort(x),
                 lambda: tams.ams_sort(x),
                 lambda: tms.two_stage_sort(x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("key_bits,p,n_local", [(18, 8, 1024),
                                                (47, 8, 8192)])
def test_pack_tagged_matches_reference(key_bits, p, n_local):
    """31 and 63 total bits: int32 and int64 packing (the reference's
    int64 case needs jax x64)."""
    rng = np.random.default_rng(key_bits)
    keys = rng.integers(0, 2 ** key_bits, size=(p, n_local), dtype=np.int64)
    shard = np.arange(p)[:, None]
    assert ttag.tag_bits(p, n_local) + key_bits in (31, 63)
    with jax.enable_x64(key_bits > 31 - ttag.tag_bits(p, n_local)):
        want = rtag.pack_tagged(jnp.asarray(keys), jnp.asarray(shard),
                                p=p, n_local=n_local, key_bits=key_bits)
        back = rtag.unpack_tagged(want, p=p, n_local=n_local)
        want, back = np.asarray(want), np.asarray(back)
    got = ttag.pack_tagged(torch.from_numpy(keys), torch.from_numpy(shard),
                           p=p, n_local=n_local, key_bits=key_bits)
    assert_bits_equal(got, want, "packed")
    assert_bits_equal(ttag.unpack_tagged(got, p=p, n_local=n_local), back,
                      "unpacked")
    np.testing.assert_array_equal(to_numpy(ttag.unpack_tagged(
        got, p=p, n_local=n_local)).astype(np.int64), keys)
    # the tags make every packed key distinct, ordered by (key, shard, i)
    flat = to_numpy(got).reshape(-1)
    assert np.unique(flat).size == flat.size


def test_pack_tagged_refuses_past_63_bits():
    with pytest.raises(ValueError, match="> 63"):
        ttag.pack_tagged(torch.zeros(8, dtype=torch.int64), 0, p=8,
                         n_local=8, key_bits=58)
    with pytest.raises(ValueError, match="> 63"):
        rtag.pack_tagged(jnp.zeros(8, jnp.int32), 0, p=8, n_local=8,
                         key_bits=58)


@pytest.mark.parametrize("policy", ["auto", "kernel", "torch"])
@pytest.mark.parametrize("n,m", [(4096, 256), (1000, 33), (5, 1)])
def test_probe_counts_matches_reference(n, m, policy):
    """Keys in any order against sorted probes: the reference's counting
    kernel in interpret mode, and np.histogram's half-open buckets."""
    rng = np.random.default_rng(n + m)
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, size=n, dtype=np.int32)
    probes = np.sort(rng.integers(-2 ** 31, 2 ** 31 - 1, size=m,
                                  dtype=np.int32))
    want = np.asarray(rhops.probe_counts(jnp.asarray(keys),
                                         jnp.asarray(probes),
                                         interpret=True))
    got = thops.probe_counts(torch.from_numpy(keys), torch.from_numpy(probes),
                             policy=policy)
    assert_bits_equal(got, want, "counts")
    edges = np.concatenate([[-2 ** 31], probes.astype(np.int64), [2 ** 32]])
    hist = np.array([np.sum((keys >= lo) & (keys < hi))
                     for lo, hi in zip(edges[:-1], edges[1:])])
    np.testing.assert_array_equal(to_numpy(got), hist)


def test_probe_counts_routes_to_the_counting_kernel(monkeypatch):
    """Under the kernel policy the ranks come from K4's wrapper, whatever
    the key order (its plain version on a CPU tensor)."""
    from repro_torch.kernels.histogram import kernel as hk

    seen = []
    real = hk.probe_rank_count
    monkeypatch.setattr(hk, "probe_rank_count",
                        lambda k, p: seen.append(k.shape) or real(k, p))
    keys = torch.from_numpy(np.random.default_rng(0).permutation(
        4096).astype(np.int32))
    thops.probe_counts(keys, torch.tensor([10, 2000, 3000],
                                          dtype=torch.int32),
                       policy="kernel")
    assert seen == [(1, 4096)]
    assert cuda.launches["probe_rank_count"] == 0   # the CPU ran no kernel


@pytest.mark.parametrize("runs,run", [(8, 256), (3, 1000), (1, 64)])
def test_merge_flat_runs_matches_reference(runs, run):
    rng = np.random.default_rng(runs * run)
    x = np.sort(rng.integers(-2 ** 31, 2 ** 31 - 1, size=(runs, run),
                             dtype=np.int32), axis=1).reshape(-1)
    want = np.asarray(rmops.merge_flat_runs(jnp.asarray(x), run,
                                            interpret=True))
    got = tmops.merge_flat_runs(torch.from_numpy(x), run)
    assert_bits_equal(got, want, "merged")
    np.testing.assert_array_equal(to_numpy(got), np.sort(x))
    with pytest.raises(ValueError, match="multiple"):
        tmops.merge_flat_runs(torch.from_numpy(x), run + 1)
