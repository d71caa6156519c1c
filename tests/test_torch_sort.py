"""The port's main path through `repro_torch.sort.sort` against the reference.

With the reference's own sampling draws injected, the port must reproduce
`repro.sort.sort` bit for bit — shards, counts, splitter keys and ranks,
overflow, indices and every SplitterStats field — over every input
distribution (adversarial family included), for int32, uint32 and float32
keys, ragged n, p in {1, 2, 4, 8} (and 3, 5, 6 under "kernel"), and both
the torch policy and the kernels' plain versions. Zero tolerance
throughout.
"""
import numpy as np
import pytest
import torch

import repro.sort as rsort
import repro_torch.sort as tsort
from repro.data import distributions as rdist
from repro_torch.data import distributions as tdist
from torch_parity import (
    assert_sort_outputs_equal, auto_mesh, port_spec, reference_uniform,
    sort_both)

N_RAGGED = 4099          # not a multiple of any p > 1 tested here


def _both(x, p, port_overrides=None, **spec_kw):
    """Run the reference and the port (reference draws injected)."""
    ref_spec = rsort.SortSpec(mesh=auto_mesh(p), **spec_kw)
    want = rsort.sort(x, ref_spec)
    n_local = -(-x.shape[0] // p)
    k = ref_spec.hss_config().resolved_rounds(p)
    got = tsort.sort(x, port_spec(ref_spec, p, **(port_overrides or {})),
                     uniform=reference_uniform(ref_spec.seed, p, n_local, k))
    return got, want


@pytest.mark.parametrize("name", sorted(tdist.DISTRIBUTIONS))
def test_distributions_match_reference(name):
    x = tdist.make_distribution(name, N_RAGGED, seed=3)
    np.testing.assert_array_equal(x, rdist.make_distribution(name, N_RAGGED,
                                                             seed=3))
    got, want = _both(x, 8)
    assert_sort_outputs_equal(got, want)
    if int(want.overflow) == 0:
        np.testing.assert_array_equal(got.gather(), np.sort(x))


@pytest.mark.parametrize("name", sorted(set(tdist.ADVERSARIAL)
                                        - {"DTYPE_EXTREME"}))
def test_adversarial_match_reference(name):
    x = tdist.make_adversarial(name, N_RAGGED, seed=4)
    got, want = _both(x, 8)
    assert_sort_outputs_equal(got, want)


def test_dtype_extreme_float32_matches_reference():
    x = tdist.make_adversarial("DTYPE_EXTREME", N_RAGGED, seed=5,
                               dtype=np.float32)
    got, want = _both(x, 8)
    assert_sort_outputs_equal(got, want)


def test_dtype_extreme_int32_refused_by_both():
    """Neither package packs int32 min..max keys into int32: they force
    tagging (sentinel collision) and 32 key bits plus the tag bits pass
    30. The reference refuses them with x64 off; the port packs them into
    int64, as the reference does under x64, and the two agree there."""
    x = tdist.make_adversarial("DTYPE_EXTREME", N_RAGGED, seed=5)
    with pytest.raises(ValueError, match="x64"):
        rsort.sort(x, rsort.SortSpec(mesh=auto_mesh(8)))
    got, want = sort_both(x, 8, x64=True)
    assert_sort_outputs_equal(got, want, x64=True)
    assert got.indices.dtype == torch.int64
    np.testing.assert_array_equal(got.gather(), np.sort(x))


def _keys(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.standard_normal(n).astype(np.float32)
    if dtype == np.uint32:
        return rng.integers(0, 2 ** 32 - 1, size=n, dtype=np.uint32)
    return rng.integers(-2 ** 31, 2 ** 31 - 1, size=n, dtype=np.int32)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_dtypes_and_shards_match_reference(dtype, p):
    x = _keys(dtype, N_RAGGED, seed=p)
    got, want = _both(x, p)
    assert_sort_outputs_equal(got, want)
    np.testing.assert_array_equal(got.gather(), np.sort(x))


@pytest.mark.parametrize("policy", ["kernel", "torch"])
def test_policies_match_reference(policy):
    """The reference runs its XLA path; the port's "kernel" policy runs
    the kernels' plain versions — the same bits either way."""
    x = tdist.make_distribution("GAUSS", N_RAGGED, seed=6)
    got, want = _both(x, 4, port_overrides={"kernel_policy": policy})
    assert_sort_outputs_equal(got, want)


def test_stable_indices_match_reference():
    x = tdist.make_distribution("SKEW2", N_RAGGED, seed=7)
    got, want = _both(x, 8, stable=True)
    assert_sort_outputs_equal(got, want)
    order = got.gather_indices()
    np.testing.assert_array_equal(order, np.argsort(x, kind="stable"))


def test_warm_start_matches_reference():
    x = tdist.make_distribution("UNIF", N_RAGGED, seed=8)
    probes = np.quantile(x, np.linspace(0.1, 0.9, 7)).astype(np.int32)
    got, want = _both(x, 8, initial_probes=probes, tag=False)
    assert_sort_outputs_equal(got, want)


def test_own_draws_sort_exactly():
    """Without injected draws the port samples from its own generator:
    only the gathered result can be held to the reference then."""
    x = tdist.make_distribution("UNIF", N_RAGGED, seed=9)
    out = tsort.sort(x, tsort.SortSpec(device="cpu", seed=1))
    assert int(out.overflow) == 0
    np.testing.assert_array_equal(out.gather(), np.sort(x))
    again = tsort.sort(x, tsort.SortSpec(device="cpu", seed=1,
                                         kernel_policy="kernel"))
    np.testing.assert_array_equal(again.shards.numpy(), out.shards.numpy())
    np.testing.assert_array_equal(again.counts.numpy(), out.counts.numpy())


@pytest.mark.parametrize("p", [3, 5, 6])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_odd_shard_counts_kernel_policy_match_reference(dtype, p):
    """p not a power of two under "kernel": the shard length ceil(n/p) is
    not one either, so every local sort sends sentinel-padded rows through
    `sort_blocks` (the kernels' plain versions on the CPU)."""
    x = _keys(dtype, N_RAGGED, seed=10 + p)
    got, want = _both(x, p, port_overrides={"kernel_policy": "kernel"})
    assert_sort_outputs_equal(got, want)
    np.testing.assert_array_equal(got.gather(), np.sort(x))
