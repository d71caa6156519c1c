"""The grouping front doors against the reference, bit for bit:
`semisort`, `semisort_batched` and `groupby_aggregate` (every op) on the
adversarial family (DTYPE_EXTREME takes the tagged fallback) for int32,
uint32 and float32 keys at N = 999 over p = 8; `top_k` and
`top_k_batched` (k = 1 .. n, dtype-max keys); `heavy_candidates`,
`pad_to_shards_lo`, `partition_sorted`; and the MoE dispatch helpers
`group_slots`, `grouping_permutation` and `counting_dispatch` with
invalid ids.

The reference's `tests/test_semisort.py` does not collect under jax 0.9.0
(it imports `jax.experimental.enable_x64`), so its functions are called
directly. Where the tagged sort needs int64 packing the reference runs
under `jax.enable_x64(True)`.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.splitters as rsplit
import repro.sort.driver as rdriver
import repro.sort.grouping as rgroup
import repro_torch.sort as tsort
from repro.sort import SortSpec as RefSortSpec
from repro_torch.core.splitters import heavy_candidates
from repro_torch.core.tagging import (
    float32_to_sortable_int32, sortable_int32_to_float32)
from repro_torch.data import distributions as tdist
from repro_torch.parallel.comm import Comm
from repro_torch.sort import driver as tdriver
from repro_torch.sort import grouping as tgroup
from repro_torch.sort.partitioners import ShardCtx, get_partitioner
from torch_parity import (
    assert_bits_equal, assert_counters_equal, assert_semisort_equal,
    assert_stats_equal, auto_mesh, groupby_both, reference_draws,
    semisort_batched_both, semisort_both, to_numpy, top_k_batched_both,
    top_k_both)

N = 999
NAMES = ["ALL_EQUAL", "ZIPF_HH", "PRESORTED", "REVERSE", "SAWTOOTH",
         "DTYPE_EXTREME"]
DTYPES = [np.int32, np.uint32, np.float32]


def _keys(name, dtype, n=N, seed=3):
    """An adversarial input as int32, uint32 or float32. DTYPE_EXTREME
    hits the dtype's corners (uint32: the int32 corners' bit patterns,
    the dtype max among them)."""
    if name == "DTYPE_EXTREME":
        if dtype == np.uint32:
            return tdist.make_adversarial(name, n, seed=seed).view(np.uint32)
        return tdist.make_adversarial(name, n, seed=seed, dtype=dtype)
    return tdist.make_adversarial(name, n, seed=seed).astype(dtype)


def _x64(name, dtype):
    """The tagged fallback of integer dtype-max keys packs int64."""
    return name == "DTYPE_EXTREME" and dtype != np.float32


def _unique(x):
    """np.unique by the keys' total order (-0.0 before +0.0, as the
    sortable encoding orders floats) -> (keys, counts)."""
    if x.dtype != np.float32:
        return np.unique(x, return_counts=True)
    enc = float32_to_sortable_int32(torch.from_numpy(x))
    uk, uc = np.unique(enc.numpy(), return_counts=True)
    return sortable_int32_to_float32(torch.from_numpy(uk)).numpy(), uc


def _check_groups(out, x):
    """The heavy counts and the light multiset together equal the
    input's; on the untagged path each key lies on one shard only (the
    tagged fallback is a total sort, which may split a class at a shard
    edge and stays contiguous)."""
    keys, counts = out.groups()
    uk, uc = _unique(x)
    assert_bits_equal(keys, uk, "group keys")
    np.testing.assert_array_equal(counts, uc)
    light = out.light
    if light.indices is not None:
        return
    shards, n = to_numpy(light.shards), to_numpy(light.counts)
    owner = {}
    for s in range(shards.shape[0]):
        for key in np.unique(shards[s, :n[s]]):
            assert owner.setdefault(key.tobytes(), s) == s, key
    for key in out.heavy_keys:
        assert key.tobytes() not in owner


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_semisort_matches_reference(name, dtype):
    """On the exact allgather exchange; the dense one below."""
    x = _keys(name, dtype)
    x64 = _x64(name, dtype)
    got, want = semisort_both(x, 8, x64=x64, exchange="allgather")
    assert_semisort_equal(got, want, x64=x64)
    _check_groups(got, x)
    if name == "DTYPE_EXTREME" and dtype != np.float32:
        assert got.light.indices is not None and got.heavy_keys.size == 0
    if name == "ZIPF_HH":
        assert got.heavy_keys.size > 0


@pytest.mark.parametrize("name", ["ZIPF_HH", "PRESORTED", "SAWTOOTH"])
def test_semisort_dense_matches_reference(name):
    """The default dense exchange: presorted lights overflow it in both
    packages alike (the keys-only semisort runs no overflow policy); the
    groups are checked where nothing was dropped."""
    x = _keys(name, np.int32)
    got, want = semisort_both(x, 8)
    assert_semisort_equal(got, want)
    if int(got.overflow) == 0:
        _check_groups(got, x)


def test_semisort_multistage_fallback_matches_reference():
    """Multistage owns its pipeline: the masked lights run through it and
    the valid count is cut at the first sentinel."""
    x = _keys("ZIPF_HH", np.int32)
    got, want = semisort_both(x, 8, algorithm="multistage", stages=(2, 4),
                              out_slack=2.0)
    assert_semisort_equal(got, want)
    assert int(got.overflow) == 0
    _check_groups(got, x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_semisort_batched_matches_reference(name, dtype):
    xs = np.stack([_keys(name, dtype, seed=s) for s in range(3)])
    x64 = _x64(name, dtype)
    got, want = semisort_batched_both(xs, 8, x64=x64, exchange="allgather")
    assert got.batch == want.batch == 3
    with jax.enable_x64(x64):
        assert_bits_equal(got.heavy_keys, want.heavy_keys, "heavy_keys")
        assert_counters_equal(got.heavy_counts, want.heavy_counts,
                              "heavy_counts", x64)
        gl, wl = got.light, want.light
        for f in ("shards", "splitter_keys"):
            assert_bits_equal(getattr(gl, f), getattr(wl, f), f)
        for f in ("counts", "splitter_ranks", "overflow"):
            assert_counters_equal(getattr(gl, f), getattr(wl, f), f, x64)
        assert_stats_equal(getattr(gl.stats, "splitter", gl.stats),
                           getattr(wl.stats, "splitter", wl.stats), x64)
        for b in range(3):
            assert_bits_equal(got.gather(b), want.gather(b), f"gather({b})")
    for b in range(3):
        _check_groups(got.request(b), xs[b])
    if not x64:   # the untagged plan is per row: row b is semisort(row b)
        spec = tsort.SortSpec(shards=8, device="cpu", exchange="allgather")
        draws = reference_draws(RefSortSpec(mesh=auto_mesh(8)), 8, N)
        for b in range(3):
            one = tsort.semisort(xs[b], spec=spec, uniform=draws)
            view = got.request(b)
            assert_bits_equal(view.heavy_keys, one.heavy_keys)
            assert_bits_equal(view.heavy_counts, one.heavy_counts)
            assert torch.equal(view.light.shards, one.light.shards)


def _values(n, seed=4):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("op", ["count", "sum", "mean", "max"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_groupby_aggregate_matches_reference(name, dtype, op):
    """count rides the semisort; sum, mean and max the stable sort_kv
    (int64 packing for wide keys: the reference under x64)."""
    x = _keys(name, dtype)
    v = _values(N)
    x64 = op != "count" or _x64(name, dtype)
    got, want = groupby_both(x, None if op == "count" else v, op, 8,
                             x64=x64, exchange="allgather")
    assert_bits_equal(got[0], want[0], "keys")
    assert_bits_equal(got[1], want[1], "aggregates")
    # count groups by the total order (-0.0 apart from +0.0); the value
    # ops group with np.unique, which merges them: the reference's own
    uk = _unique(x)[0] if op == "count" else np.unique(x)
    assert_bits_equal(got[0], uk, "keys vs np.unique")


@pytest.mark.parametrize("k", [1, 37, N])
@pytest.mark.parametrize("dtype", DTYPES)
def test_top_k_matches_reference(dtype, k):
    """dtype-max keys among the input win; the LO pads never do."""
    x = tdist.make_distribution("UNIF", N, seed=5).astype(dtype)
    x[::50] = (np.finfo(dtype).max if dtype == np.float32
               else np.iinfo(dtype).max)
    got, want = top_k_both(x, k, 8)
    assert_bits_equal(got, want)
    assert_bits_equal(got, np.sort(x)[::-1][:k], "np.sort")


@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_top_k_batched_matches_reference(dtype, p):
    xs = np.stack([tdist.make_distribution("UNIF", N, seed=s)
                   for s in range(3)]).astype(dtype)
    xs[1, :7] = np.iinfo(np.int32).min if dtype == np.int32 else 0
    got, want = top_k_batched_both(xs, 40, p)
    assert_bits_equal(got, want)
    spec = tsort.SortSpec(shards=p, device="cpu")
    for b in range(3):
        assert_bits_equal(got[b], tsort.top_k(xs[b], 40, spec))


def test_top_k_comm_is_one_all_gather():
    """The pruning contract: exactly one all_gather, no all_to_all."""
    tsemi = importlib.import_module("repro_torch.sort.semisort")
    rows = torch.sort(torch.randint(0, 99, (8, 2, 125)), dim=-1).values
    comm = Comm(8)
    tsemi.topk_program(rows.to(torch.int32), comm, 40, 37, "torch")
    assert comm.log == {"all_gather": 1}


def test_heavy_candidates_match_reference():
    rng = np.random.default_rng(9)
    for _ in range(4):
        s = np.sort(np.concatenate([
            rng.integers(0, 6, 40), rng.integers(0, 1000, 60),
            np.full(rng.integers(0, 9), np.iinfo(np.int32).max)
        ]).astype(np.int32))
        for min_count, max_heavy in ((1, 8), (3, 16), (5, 104)):
            want = np.asarray(rsplit.heavy_candidates(
                jnp.asarray(s), max_heavy=max_heavy, min_count=min_count))
            got = heavy_candidates(torch.from_numpy(s)[None],
                                   max_heavy=max_heavy, min_count=min_count)
            assert_bits_equal(got[0], want)


@pytest.mark.parametrize("n,p", [(16, 8), (13, 8), (7, 3)])
def test_pad_to_shards_lo_matches_reference(n, p):
    x = np.arange(n, dtype=np.int32) - 3
    want, w_pad = rdriver.pad_to_shards_lo(jnp.asarray(x), p)
    got, g_pad = tdriver.pad_to_shards_lo(torch.from_numpy(x), p)
    assert g_pad == w_pad
    assert_bits_equal(got, np.asarray(want))


def test_partition_sorted_is_the_batched_row():
    x = torch.from_numpy(tdist.make_distribution("UNIF", 8 * 125, seed=6))
    rows = torch.sort(x.reshape(8, 125), dim=-1).values
    rows[:, 120:] = np.iinfo(np.int32).max
    spec = tsort.SortSpec(shards=8, device="cpu")
    u = lambda j, n: torch.rand((8, n), generator=torch.Generator()
                                .manual_seed(j))
    part = get_partitioner("hss")
    one = part.partition_sorted(rows, ShardCtx(spec, Comm(8), u),
                                n_valid=torch.full((8,), 120))
    many = part.partition_sorted_batched(rows[:, None],
                                         ShardCtx(spec, Comm(8), u),
                                         n_valid=120)
    assert torch.equal(one[0], many[0][:, 0])        # out (p, cap)
    assert torch.equal(one[1], many[1][:, 0])        # n_out (p,)
    for a, b in zip(one[2:5], many[2:5]):            # keys, ranks, ovf
        assert torch.equal(a, b[0])
    assert int(one[1].sum()) == 8 * 120


def _ids(n, n_groups, invalid):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, n_groups, n).astype(np.int32)
    ids[rng.random(n) < 0.15] = rng.choice(invalid, size=1)[0]
    ids[::13] = rng.choice(invalid, size=ids[::13].shape)
    return ids


@pytest.mark.parametrize("method", ["counting", "argsort"])
@pytest.mark.parametrize("invalid", [(-1,), (-1, 16, 99, -5)])
def test_counting_dispatch_matches_reference(method, invalid):
    ids = _ids(1000, 16, invalid)
    want = rgroup.counting_dispatch(jnp.asarray(ids), 16, 48, method=method)
    got = tgroup.counting_dispatch(torch.from_numpy(ids), 16, 48,
                                   method=method)
    for g, w, what in zip(got, want, ("order", "slot", "keep")):
        assert_bits_equal(g, np.asarray(w), what)
    if invalid == (-1,):    # MoE-shaped ids: both methods the same bits
        other = tgroup.counting_dispatch(
            torch.from_numpy(ids), 16, 48,
            method="argsort" if method == "counting" else "counting")
        for g, o in zip(got, other):
            assert torch.equal(g, o)


def test_grouping_permutation_and_group_slots_match_reference():
    ids = _ids(777, 5, (-1, 5, 12))
    want = rgroup.grouping_permutation(jnp.asarray(ids), 5)
    got = tgroup.grouping_permutation(torch.from_numpy(ids), 5)
    assert_bits_equal(got, np.asarray(want))
    srt = np.sort(ids)
    ws, wk = rgroup.group_slots(jnp.asarray(srt), 5, 30)
    gs, gk = tgroup.group_slots(torch.from_numpy(srt), 5, 30)
    assert_bits_equal(gs, np.asarray(ws))
    assert_bits_equal(gk, np.asarray(wk))
    assert tgroup.DEFAULT_DISPATCH_METHOD == rgroup.DEFAULT_DISPATCH_METHOD
    with pytest.raises(ValueError):
        tgroup.counting_dispatch(torch.from_numpy(ids), 5, 30, method="x")
