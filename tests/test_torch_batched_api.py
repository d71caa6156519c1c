"""The rest of the batched front door: tagged batches, the kernels' plain
versions, a (B, m) warm start, `sort(xs, SortSpec(batch=True))` and the
unbatched allgather sort against the reference (its draws injected); then
the port against itself — batched row b equals `sort()` of row b with
`tag` fixed — and list input through `group_by_length`. Zero tolerance.
"""
import numpy as np
import pytest

import repro.sort as rsort
import repro_torch.sort as tsort
from repro_torch.data import distributions as tdist
from torch_parity import (
    assert_batched_outputs_equal, assert_sort_outputs_equal, auto_mesh,
    port_spec, random_keys, reference_draws, sort_batched_both)


@pytest.mark.parametrize("exchange", ["dense", "allgather"])
def test_tagged_batch_matches_reference(exchange):
    """Duplicates in one row tag the whole batch (one shared plan), with
    ragged n: pads, per-row index tags and the shared rebase offset."""
    rng = np.random.default_rng(4)
    xs = np.stack([tdist.make_distribution("SKEW2", 2051, seed=0),
                   rng.integers(0, 2 ** 16, 2051).astype(np.int32),
                   rng.integers(-2 ** 12, 2 ** 12, 2051).astype(np.int32)])
    got, want = sort_batched_both(xs, 8, exchange=exchange, stable=True)
    assert got.indices is not None
    assert_batched_outputs_equal(got, want)
    for b in range(3):
        np.testing.assert_array_equal(got.gather_indices(b),
                                      np.argsort(xs[b], kind="stable"))


def test_kernel_policy_matches_reference():
    xs = np.stack([tdist.make_distribution("GAUSS", 2048, seed=s)
                   for s in range(3)])
    got, want = sort_batched_both(
        xs, 4, port_overrides={"kernel_policy": "kernel"},
        exchange="allgather")
    assert_batched_outputs_equal(got, want)


def test_warm_start_rows_match_reference():
    xs = np.stack([tdist.make_distribution("UNIF", 2048, seed=s)
                   for s in range(3)])
    probes = np.sort(np.quantile(xs, np.linspace(0.1, 0.9, 7), axis=1).T,
                     axis=1).astype(np.int32)               # (B, m)
    got, want = sort_batched_both(xs, 8, initial_probes=probes, tag=False)
    assert_batched_outputs_equal(got, want)


def test_spec_batch_routes_sort():
    xs = random_keys(np.int32, (3, 2048), seed=1)
    ref_spec = rsort.SortSpec(mesh=auto_mesh(4), batch=True)
    want = rsort.sort(xs, ref_spec)
    got = tsort.sort(xs, port_spec(ref_spec, 4, batch=True),
                     uniform=reference_draws(ref_spec, 4, 2048))
    assert isinstance(got, tsort.BatchedSortOutput)
    assert_batched_outputs_equal(got, want)


@pytest.mark.parametrize("p", [2, 8])
def test_unbatched_allgather_sort_matches_reference(p):
    x = tdist.make_distribution("SKEW1", 4099, seed=p)
    ref_spec = rsort.SortSpec(mesh=auto_mesh(p), exchange="allgather")
    want = rsort.sort(x, ref_spec)
    got = tsort.sort(x, port_spec(ref_spec, p),
                     uniform=reference_draws(ref_spec, p, x.shape[0]))
    assert_sort_outputs_equal(got, want)
    np.testing.assert_array_equal(got.gather(), np.sort(x))


# ------------------------------------------- the port against itself
@pytest.mark.parametrize("tag", [False, True])
@pytest.mark.parametrize("exchange", ["dense", "allgather"])
def test_batched_equals_per_row_sort(tag, exchange):
    """With `tag` fixed both plans agree, and batched row b equals sort()
    of row b alone with the same seed: the same shards, counts, splitters
    and stats row."""
    rng = np.random.default_rng(5)
    xs = rng.integers(0, 2 ** 16, (3, 2051)).astype(np.int32)
    xs[1] += 2 ** 16              # the rows' key ranges differ
    spec = tsort.SortSpec(device="cpu", shards=4, tag=tag, seed=3,
                          exchange=exchange)
    out = tsort.sort_batched(xs, spec)
    for b in range(3):
        one = tsort.sort(xs[b], spec)
        view = out.request(b)
        for name in ("shards", "counts", "splitter_keys", "splitter_ranks",
                     "overflow"):
            np.testing.assert_array_equal(getattr(view, name).numpy(),
                                          getattr(one, name).numpy(), name)
        for field, a in zip(one.stats._fields, one.stats):
            np.testing.assert_array_equal(
                getattr(out.stats, field)[..., b].numpy(), a.numpy(), field)
        np.testing.assert_array_equal(out.gather(b), np.sort(xs[b]))


def test_list_input_buckets_by_length():
    """Five 1,000-key and three 1,003-key requests, interleaved: two
    length buckets, results in input order, each equal to np.sort and to
    the (B, n) batch of its bucket."""
    lengths = [1000, 1003, 1000, 1000, 1003, 1000, 1003, 1000]
    arrs = [random_keys(np.float32, (n,), seed=i)
            for i, n in enumerate(lengths)]
    spec = tsort.SortSpec(device="cpu", shards=8)
    outs = tsort.sort_batched(arrs, spec)
    assert len(outs) == len(arrs)
    assert all(isinstance(o, tsort.SortOutput) for o in outs)
    for a, o in zip(arrs, outs):
        np.testing.assert_array_equal(o.gather(), np.sort(a))
    for n, idxs in tsort.group_by_length(arrs).items():
        bucket = tsort.sort_batched(np.stack([arrs[i] for i in idxs]), spec)
        for j, i in enumerate(idxs):
            np.testing.assert_array_equal(outs[i].shards.numpy(),
                                          bucket.shards[j].numpy())
    assert list(tsort.group_by_length(arrs)) == [1000, 1003]
    with pytest.raises(ValueError):
        tsort.sort_batched([np.zeros((2, 3), np.int32)], spec)


def test_bad_inputs_raise():
    spec = tsort.SortSpec(device="cpu", shards=2)
    with pytest.raises(ValueError):
        tsort.sort_batched(np.zeros(8, np.int32), spec)
    with pytest.raises(ValueError):
        tsort.sort_batched(np.zeros((2, 0), np.int32), spec)
    with pytest.raises(ValueError, match="unknown exchange"):
        tsort.sort_batched(np.zeros((2, 8), np.int32), spec,
                           exchange="ragged_v2")
