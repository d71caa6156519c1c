"""Kernel-policy dispatch: the port's "kernel" and "torch" policies against
`repro.kernels.dispatch` under "pallas" (interpret mode) and "xla".

Every pairing must give the same bits: local sorts (sentinel tails and
duplicates included), probe ranks with and without `assume_sorted`, and
the post-exchange k-way merge. The port's entry points take rows; the
reference's take one array, so each row is held to one reference call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as rd
from repro_torch.kernels import dispatch as td

PAIRS = [("kernel", "pallas"), ("torch", "xla")]
INT_MAX = np.iinfo(np.int32).max


def _keys(rng, shape, dups=False):
    if dups:
        return rng.integers(0, 16, size=shape).astype(np.int32)
    return rng.integers(-2 ** 31, 2 ** 31 - 1, size=shape).astype(np.int32)


def test_policy_names_and_resolution():
    assert td.POLICIES == ("auto", "kernel", "torch")
    assert td.AUTO_SORT_MAX_N == rd.AUTO_SORT_MAX_N
    assert td.resolve_policy("auto", "cpu") == "torch"
    assert td.resolve_policy("auto", "cuda") == "kernel"
    assert rd.resolve_policy("auto") == "xla"     # the reference on CPU
    assert td.resolve_policy("kernel", "cpu") == "kernel"
    with pytest.raises(ValueError):
        td.resolve_policy("pallas", "cpu")


@pytest.mark.parametrize("port,ref", PAIRS)
@pytest.mark.parametrize("n,dups,tail", [(1000, False, 0), (2048, True, 0),
                                         (777, False, 100)])
def test_local_sort_matches_reference(rng, port, ref, n, dups, tail):
    x = _keys(rng, (2, n), dups)
    if tail:
        x[:, -tail:] = INT_MAX
    got = td.local_sort(torch.from_numpy(x), policy=port)
    for r in range(2):
        want = rd.local_sort(jnp.asarray(x[r]), policy=ref)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))


@pytest.mark.parametrize("port,ref", PAIRS)
@pytest.mark.parametrize("assume_sorted", [True, False])
def test_probe_ranks_matches_reference(rng, port, ref, assume_sorted):
    keys = _keys(rng, (3, 1500), dups=True)
    if assume_sorted:
        keys = np.sort(keys, axis=-1)
    probes = np.sort(_keys(rng, (40,), dups=True))
    got = td.probe_ranks(torch.from_numpy(keys), torch.from_numpy(probes),
                         policy=port, assume_sorted=assume_sorted)
    assert got.dtype == torch.int32 and got.shape == (3, 40)
    for r in range(3):
        want = rd.probe_ranks(jnp.asarray(keys[r]), jnp.asarray(probes),
                              policy=ref, assume_sorted=assume_sorted)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))


def test_probe_ranks_empty_probes(rng):
    keys = torch.from_numpy(_keys(rng, (2, 10)))
    got = td.probe_ranks(keys, torch.zeros((0,), dtype=torch.int32))
    assert got.shape == (2, 0) and got.dtype == torch.int32


@pytest.mark.parametrize("port,ref", PAIRS)
@pytest.mark.parametrize("k,r", [(8, 96), (3, 64), (4, 1)])
def test_merge_runs_matches_reference(rng, port, ref, k, r):
    runs = np.sort(_keys(rng, (2, k, r), dups=True), axis=-1)
    runs[:, :, r - r // 3:] = INT_MAX       # sentinel-padded run tails
    got = td.merge_runs(torch.from_numpy(runs), policy=port)
    for row in range(2):
        want = rd.merge_runs(jnp.asarray(runs[row]), policy=ref)
        np.testing.assert_array_equal(got[row].numpy(), np.asarray(want))
