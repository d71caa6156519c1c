"""K4s and K5 on 64-bit keys: the int64 plain versions against
`torch.searchsorted` and `torch.sort`, and the sorts whose tags pack into
int64 through them.

The keys are implicit tags packed as the front door packs them
(`sort.adapters.AdapterPlan.encode`, (key << b) | index) into int64: 35-
and 58-bit packs, made at small n from keys that repeat over a wide range
(22 and 45 key bits), so the pack is int64 although the tag bits are few.
Rows have valid prefixes of different lengths and the INT64_MAX sentinel
past them, and some keys equal INT64_MAX as well. Zero tolerance
throughout. On the card, the kernels themselves are held to these plain
versions by tests/test_torch_cuda.py and chip_smoke.py.

    PYTHONPATH=src python -m pytest -q tests/test_torch_wide_kernels.py
"""
import numpy as np
import pytest
import torch

import repro_torch.sort as tsort
from repro_torch.kernels import dispatch
from repro_torch.kernels.histogram import kernel as thk
from repro_torch.kernels.merge import kernel as tmk
from repro_torch.kernels.merge import ops as tmops
from repro_torch.sort.adapters import make_plan
from repro_torch.sort.spec import SortSpec
from torch_parity import auto_on_card  # noqa: F401

I64_MAX = torch.iinfo(torch.int64).max
P = 8
N = P * 1024                  # tag_bits(8, 1024) = 13
PACKS = {35: 22, 58: 45}      # pack bits: key bits


def _keys(rng, key_bits, n=N, distinct=300):
    """n int64 keys drawn from `distinct` values spread over
    [0, 2^key_bits): massive duplication over a wide range."""
    pool = rng.integers(0, 2 ** key_bits, distinct, dtype=np.int64)
    pool[:2] = (0, 2 ** key_bits - 1)           # the range is the whole
    return pool[rng.integers(0, distinct, n)]


def _packed(rng, bits):
    """The front door's tagged int64 pack of wide, duplicated keys."""
    x = torch.from_numpy(_keys(rng, PACKS[bits]))
    plan = make_plan(x, SortSpec(device="cpu", shards=P, tag=True), P)
    assert plan.pack_dtype == torch.int64
    assert PACKS[bits] + plan.tag_b == bits
    return plan.encode(x)


def _runs(rng, packed, rows, k, r, sentinel_keys=False):
    """(rows, k, r) sorted runs of the packed keys, each run's first
    counts[row, run] slots valid (prefixes of different lengths, some
    empty) and INT64_MAX past them; `sentinel_keys` makes a tenth of the
    valid keys INT64_MAX too."""
    vals = packed[torch.from_numpy(
        rng.integers(0, packed.numel(), (rows, k, r)))]
    if sentinel_keys:
        vals[torch.from_numpy(rng.random((rows, k, r)) < 0.1)] = I64_MAX
    counts = torch.from_numpy(rng.integers(0, r + 1, (rows, k))
                              ).to(torch.int32)
    counts[0, 0] = 0
    counts[-1, -1] = r
    vals = torch.sort(vals, dim=-1).values
    vals = torch.where(torch.arange(r) < counts[..., None], vals, I64_MAX)
    return vals, counts


def _want(x, out_len):
    rows = torch.sort(x.reshape(x.shape[0], -1), dim=-1).values
    return rows if out_len is None else tmops.cap_to(rows, out_len)


@pytest.mark.parametrize("sentinel_keys", [False, True])
@pytest.mark.parametrize("k", [2, 3, 5, 8])
@pytest.mark.parametrize("bits", sorted(PACKS))
def test_int64_plain_merge_equals_torch_sort(rng, bits, k, sentinel_keys):
    """K5's int64 levels (merge_sorted_runs on the CPU) against
    torch.sort of each row, cut below, at and above the keys' total."""
    packed = _packed(rng, bits)
    x, counts = _runs(rng, packed, 3, k, 701, sentinel_keys)
    totals = counts.sum(-1)
    for out_len in (None, int(totals.min()) // 2 + 1, int(totals.max()),
                    k * 701 + 5):
        got = dispatch.merge_runs(x, policy="kernel", counts=counts,
                                  out_len=out_len)
        assert got.dtype == torch.int64
        assert torch.equal(got, _want(x, out_len))


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("bits", sorted(PACKS))
def test_int64_plain_merge_level_merges_each_pair(rng, bits, k):
    """One level: output run j is runs 2j and 2j+1 merged (an odd last
    run alone), its count their sum, INT64_MAX past it."""
    packed = _packed(rng, bits)
    x, counts = _runs(rng, packed, 2, k, 333)
    out, merged = tmk.merge_path_pairs(x, counts)
    assert out.dtype == torch.int64 and merged.dtype == torch.int32
    for j in range(out.shape[1]):
        pair = x[:, 2 * j:2 * j + 2]
        assert torch.equal(out[:, j], _want(pair, 2 * 333))
        assert torch.equal(merged[:, j],
                           counts[:, 2 * j:2 * j + 2].sum(-1).to(torch.int32))


@pytest.mark.parametrize("n", [31, 32, 33, 1000, 40_003])
@pytest.mark.parametrize("bits", sorted(PACKS))
def test_int64_plain_search_equals_searchsorted(rng, bits, n):
    """K4s's int64 schedule (probe_rank_search on the CPU) against
    torch.searchsorted: rows sorted with INT64_MAX tails of different
    lengths, probes from the keys, between them, past both ends and at
    the sentinel."""
    packed = _packed(rng, bits)
    rows, m = 3, 97
    keys = packed[torch.from_numpy(rng.integers(0, packed.numel(),
                                                (rows, n)))]
    keys = torch.sort(keys, dim=-1).values
    valid = torch.from_numpy(rng.integers(0, n + 1, (rows, 1)))
    keys = torch.where(torch.arange(n) < valid, keys, I64_MAX)
    probes = keys[:, torch.from_numpy(rng.integers(0, n, m))].clone()
    probes[:, 1::4] += 1
    probes[:, 2::8] = I64_MAX
    probes[:, 3::8] = torch.iinfo(torch.int64).min
    got = thk.probe_rank_search(keys, probes)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.searchsorted(keys, probes).to(torch.int32))
    assert torch.equal(thk.probe_ranks_search_plain(keys, probes), got)
    assert torch.equal(
        dispatch.probe_ranks(keys, probes, policy="kernel",
                             assume_sorted=True), got)


def test_int64_search_refuses_mixed_dtypes():
    keys = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(TypeError, match="differ"):
        thk.probe_rank_search(keys, torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32 or int64"):
        thk.probe_rank_search(keys.to(torch.int16),
                              torch.zeros((2, 3), dtype=torch.int16))


# -- sorts through them ---------------------------------------------------

@pytest.mark.parametrize("door", ["sort", "argsort"])
def test_tagged_sort_under_the_kernel_policy_equals_numpy(rng, door):
    """tag=True on SKEW2-like keys (7 + 13 bits, an int32 pack: under
    "kernel" an int64 pack's local sort raises) runs every kernel's plain
    version: equal to np.sort, and argsort to the stable np.argsort."""
    x = rng.integers(0, 101, N).astype(np.int32)
    spec = SortSpec(device="cpu", shards=P, tag=True, kernel_policy="kernel")
    if door == "sort":
        out = tsort.sort(x, spec)
        assert out.indices is not None
        np.testing.assert_array_equal(out.gather(), np.sort(x))
    else:
        np.testing.assert_array_equal(tsort.argsort(x, spec),
                                      np.argsort(x, kind="stable"))


@pytest.fixture
def card_route(auto_on_card, monkeypatch):
    """"auto" as it resolves on the card, on CPU tensors (`auto_on_card`):
    the kernels' plain versions where the card would launch a kernel,
    torch.sort for the 64-bit local sorts. Returns the calls of the int64
    plain K4s and K5."""
    calls = {"search": 0, "merge": 0}
    search, merge = thk.probe_ranks_search_plain, tmk.merge_path_pairs_plain

    def counted(name, fn):
        def run(x, *args, **kw):
            calls[name] += x.dtype == torch.int64
            return fn(x, *args, **kw)
        return run

    monkeypatch.setattr(thk, "probe_ranks_search_plain",
                        counted("search", search))
    monkeypatch.setattr(tmk, "merge_path_pairs_plain",
                        counted("merge", merge))
    return calls


@pytest.mark.parametrize("door", ["sort", "argsort"])
@pytest.mark.parametrize("bits", sorted(PACKS))
def test_int64_packed_sort_on_the_card_route_equals_numpy(rng, card_route,
                                                          bits, door):
    """The front door's int64 pack (35 and 58 bits) through the route
    "auto" takes on the card: its searches and merges run the int64 K4s
    and K5 (plain here), its local sorts torch.sort; the answer equals
    np.sort, argsort the stable np.argsort."""
    x = _keys(rng, PACKS[bits])
    spec = SortSpec(device="cpu", shards=P, tag=True)
    if door == "sort":
        out = tsort.sort(x, spec)
        assert out.indices.dtype == torch.int64 and int(out.overflow) == 0
        np.testing.assert_array_equal(out.gather(), np.sort(x))
    else:
        np.testing.assert_array_equal(tsort.argsort(x, spec),
                                      np.argsort(x, kind="stable"))
    assert card_route["search"] > 0 and card_route["merge"] >= 3


def test_float64_keys_take_the_same_route(rng, card_route):
    """float64 keys are encoded to int64: searched and merged by the int64
    kernels on the card route, bit-equal to np.sort."""
    x = rng.standard_normal(N)
    out = tsort.sort(x, SortSpec(device="cpu", shards=P))
    np.testing.assert_array_equal(out.gather().view(np.int64),
                                  np.sort(x).view(np.int64))
    assert card_route["search"] > 0 and card_route["merge"] >= 3


@pytest.mark.parametrize("order", ["presorted", "shuffled"])
def test_int64_ragged_exchange_on_the_card_route(rng, card_route, order):
    """The ragged exchange's two branches on int64 keys: shuffled keys
    merge their runs by the int64 K5; presorted ones outgrow the slot and
    take the full-sort branch, which is the policy's local sort
    (torch.sort for 64-bit rows)."""
    x = np.arange(N, dtype=np.int64) * (2 ** 33)
    if order == "shuffled":
        x = rng.permutation(x)
    before = dict(tmops.ragged_branches)
    out = tsort.sort(x, SortSpec(device="cpu", shards=P, exchange="ragged"))
    np.testing.assert_array_equal(out.gather(), np.sort(x))
    branch = "full_sort" if order == "presorted" else "merge_tree"
    assert tmops.ragged_branches[branch] > before.get(branch, 0)
