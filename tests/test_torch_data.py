"""The NumPy-side modules against the reference: `data.partition`
(`bucket_lengths` over the port's sort with the reference's draws
injected, ids and counts against the reference's own call;
`pack_documents`, `padding_fraction`), `data.synthetic.SyntheticTokens`
and `core.simulator` (`simulate_hss`, the baselines' simulators,
`min_sample_for_balance`), equal for the same seeds.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.core.simulator as rsim
import repro.data.partition as rpart
import repro_torch.core.simulator as tsim
import repro_torch.data.partition as tpart
import repro_torch.sort as tsort
from repro.data.synthetic import SyntheticTokens as RefTokens
from repro.sort import SortSpec as RefSortSpec
from repro_torch.data import SyntheticTokens
from repro_torch.sort import SortSpec
from repro_torch.sort.adapters import make_plan
from torch_parity import auto_mesh, reference_draws

SPEC = SortSpec(exchange="allgather", device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_shards,n_docs", [(8, 4096), (4, 999), (3, 500)])
def test_bucket_lengths_matches_reference(seed, n_shards, n_docs,
                                          monkeypatch):
    lengths = SyntheticTokens(vocab=100, seq_len=2048, global_batch=1,
                              seed=seed).doc_lengths(0, n_docs)
    want_ids, want_counts = rpart.bucket_lengths(lengths, n_shards,
                                                 seed=seed)
    ref_spec = RefSortSpec(algorithm="hss", eps=0.05, exchange="allgather",
                           seed=seed, mesh=auto_mesh(n_shards), stable=True)
    draws = reference_draws(ref_spec, n_shards, n_docs)
    monkeypatch.setattr(tpart, "sort",
                        functools.partial(tsort.sort, uniform=draws))
    ids, counts = tpart.bucket_lengths(lengths, n_shards, seed=seed,
                                       spec=SPEC)
    np.testing.assert_array_equal(counts, want_counts)
    assert counts.dtype == np.asarray(want_counts).dtype
    assert len(ids) == len(want_ids) == n_shards
    for got, want in zip(ids, want_ids):
        np.testing.assert_array_equal(got, want)
    # contiguous, non-decreasing shards that hold every doc once
    flat = np.concatenate(ids)
    np.testing.assert_array_equal(np.sort(flat), np.arange(n_docs))
    assert np.all(np.diff(lengths[flat]) >= 0)


def test_bucket_lengths_own_draws_are_a_bucketing():
    lengths = SyntheticTokens(vocab=100, seq_len=512, global_batch=1,
                              seed=1).doc_lengths(2, 3000)
    ids, counts = tpart.bucket_lengths(lengths, 8, spec=SPEC)
    flat = np.concatenate(ids)
    np.testing.assert_array_equal(np.sort(flat), np.arange(3000))
    assert np.all(np.diff(lengths[flat]) >= 0)
    assert counts.sum() == 3000
    assert counts.max() <= 1.05 * 3000 / 8 + 1


def test_bucket_lengths_packing_width():
    """The full-width cell: 1,048,576 documents (20 tag bits) of lengths
    in [16, 2048] (a 2,032-wide range, 11 bits) need 31 bits, over the
    30 that int32 packing leaves below its sentinel: the plan packs
    int64, which takes the torch route under "auto" (no kernel)."""
    lengths = SyntheticTokens(vocab=32000, seq_len=2048, global_batch=1,
                              ).doc_lengths(0, 1 << 20)
    assert (lengths.min(), lengths.max()) == (16, 2048)
    x = torch.from_numpy(lengths)[None]
    plan = make_plan(x, dataclasses.replace(SPEC, stable=True), 8)
    assert plan.tagged and plan.tag_b == 20
    assert plan.encode(x).dtype == torch.int64


@pytest.mark.parametrize("seq_len", [64, 512, 2048])
def test_packing_matches_reference(seq_len):
    rng = np.random.default_rng(seq_len)
    lengths = rng.integers(1, seq_len, 700).astype(np.int32)
    order = np.argsort(lengths, kind="stable")
    got = tpart.pack_documents(order, lengths, seq_len)
    want = rpart.pack_documents(order, lengths, seq_len)
    assert got == want
    assert tpart.padding_fraction(got, lengths, seq_len) == \
        rpart.padding_fraction(want, lengths, seq_len)


@pytest.mark.parametrize("kw", [dict(vocab=50, seq_len=16, global_batch=3),
                                dict(vocab=32000, seq_len=128,
                                     global_batch=2, seed=7)])
def test_synthetic_tokens_match_reference(kw):
    got, want = SyntheticTokens(**kw), RefTokens(**kw)
    for step in (0, 1, 17):
        for a, b in zip(got.batch(step), want.batch(step)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(got.doc_lengths(step, 257),
                                      want.doc_lengths(step, 257))


@pytest.mark.parametrize("kw", [
    dict(p=8, n_per=4096, eps=0.05), dict(p=64, n_per=2048, eps=0.02,
                                          sample_per_round=320, seed=3),
    dict(p=33, n_per=1000, eps=0.1, rounds=2, adaptive=False, seed=1),
    dict(p=2, n_per=10, eps=0.5, seed=2), dict(p=512, n_per=512, eps=0.05,
                                               seed=4)])
def test_simulate_hss_matches_reference(kw):
    got, want = tsim.simulate_hss(**kw), rsim.simulate_hss(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_baseline_simulators_match_reference():
    for seed in range(3):
        assert tsim.simulate_sample_sort_random(64, 1000, 900, seed) == \
            rsim.simulate_sample_sort_random(64, 1000, 900, seed)
        assert tsim.simulate_sample_sort_random(64, 1000, 10, seed) == \
            rsim.simulate_sample_sort_random(64, 1000, 10, seed)
        assert tsim.simulate_ams(32, 500, 0.1, 400, seed) == \
            rsim.simulate_ams(32, 500, 0.1, 400, seed)
    for s in (1, 7, 31):
        assert tsim.simulate_sample_sort_regular(16, 999, s) == \
            rsim.simulate_sample_sort_regular(16, 999, s)


def test_min_sample_for_balance_matches_reference():
    for mod_t, mod_r, target in ((tsim, rsim, 1.2), (tsim, rsim, 1.5)):
        fn_t = lambda s, seed: mod_t.simulate_sample_sort_random(32, 500, s,
                                                                 seed)
        fn_r = lambda s, seed: mod_r.simulate_sample_sort_random(32, 500, s,
                                                                 seed)
        assert mod_t.min_sample_for_balance(fn_t, target, 32, 4000) == \
            mod_r.min_sample_for_balance(fn_r, target, 32, 4000)
    assert tsim.min_sample_for_balance(lambda s, seed: 9.0, 1.1, 1, 10) == -1
