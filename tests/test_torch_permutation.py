"""The permutation front doors and the wide keys against the reference, bit
for bit: `argsort` and `sort_kv` (values of shape (n,) and (n, 3)) on
duplicate-heavy, NaN, +-0 and dtype-extreme keys; `gather_perm_checked`
raising on a short gather; int64 packing, int64 keys and float64 keys,
with the reference under `jax.enable_x64(True)` (the port packs int64
where the reference does so under x64); and the kernel policy on 64-bit
keys. The reference's draws are injected.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.sort as rsort
import repro_torch
import repro_torch.sort as tsort
from repro_torch.data import distributions as tdist
from repro_torch.kernels import dispatch
from torch_parity import (
    argsort_both, assert_bits_equal, assert_sort_outputs_equal, auto_mesh,
    sort_both, sort_kv_both)

N = 4099


def _nan_zero_float32(n, seed):
    """Normal keys with NaN payloads of both signs, -0.0, +0.0 and +-inf
    mixed in, many of them repeated."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    specials = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)
    specials = np.concatenate(
        [specials, np.array([0x7FC00001, 0xFFC00002], np.uint32)
         .view(np.float32)])
    pick = rng.integers(0, 4, n) == 0
    x[pick] = specials[rng.integers(0, len(specials), int(pick.sum()))]
    return x


#: Keys whose range packs into int32 with the tags (7 key bits + 10 or
#: 12 tag bits) in both packages.
KEYS = {
    "skew2_int32": lambda: tdist.make_distribution("SKEW2", N, seed=1),
    "few_uint32": lambda: np.random.default_rng(2).integers(
        0, 16, N).astype(np.uint32),
}
#: Keys whose range needs int64 packing (> 30 bits with the tags): the
#: reference under x64.
WIDE_KEYS = {
    "nan_zero_float32": lambda: _nan_zero_float32(N, 3),
    "extreme_float32": lambda: tdist.make_adversarial(
        "DTYPE_EXTREME", N, seed=4, dtype=np.float32),
    "extreme_int32": lambda: tdist.make_adversarial("DTYPE_EXTREME", N,
                                                    seed=5),
    "full_int32": lambda: np.random.default_rng(6).integers(
        -2 ** 31, 2 ** 31 - 1, N).astype(np.int32),
    "full_uint32": lambda: np.random.default_rng(7).integers(
        0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32),
    "normal_float32": lambda: np.random.default_rng(8).standard_normal(
        N).astype(np.float32),
}


def _stable_order(x):
    """NumPy's stable argsort over the keys' total order (floats by their
    sortable bits, so NaNs of either sign and +-0 are ordered)."""
    if x.dtype.kind == "f":
        bits = x.view(np.dtype(f"i{x.dtype.itemsize}"))
        key = np.where(bits < 0, ~bits, bits | np.iinfo(bits.dtype).min)
        x = key ^ np.iinfo(bits.dtype).min
    return np.argsort(x, kind="stable")


def _check_perm(order, x):
    np.testing.assert_array_equal(order, _stable_order(x))


@pytest.mark.parametrize("name", sorted(KEYS))
@pytest.mark.parametrize("p", [3, 8])
def test_argsort_matches_reference(name, p):
    x = KEYS[name]()
    got, want = argsort_both(x, p)
    assert_bits_equal(got, want, "argsort")
    _check_perm(got, x)


@pytest.mark.parametrize("name", sorted(WIDE_KEYS))
@pytest.mark.parametrize("p", [3, 8])
def test_argsort_int64_packing_matches_reference(name, p):
    x = WIDE_KEYS[name]()
    if p == 3:                                     # the reference, x64 off
        with pytest.raises(ValueError, match="x64"):
            rsort.argsort(x, rsort.SortSpec(mesh=auto_mesh(p)))
    got, want = argsort_both(x, p, x64=True)
    assert got.dtype == np.int64
    assert_bits_equal(got, want, "argsort")
    _check_perm(got, x)


@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("name", ["skew2_int32", "nan_zero_float32"])
def test_sort_kv_matches_reference(name, shape):
    keys_of = {**KEYS, **WIDE_KEYS}
    x = keys_of[name]()
    x64 = name in WIDE_KEYS
    values = np.arange(N * int(np.prod(shape)), dtype=np.float32).reshape(
        (N,) + shape) * 0.5
    (keys, vals), (rkeys, rvals) = sort_kv_both(x, values, 4, x64=x64)
    assert_bits_equal(keys, rkeys, "keys")
    assert_bits_equal(vals, rvals, "values")
    np.testing.assert_array_equal(vals, values[_stable_order(x)])


def test_sort_kv_moe_dispatch():
    """Expert ids in [0, 16) with the token of each slot as the value (top-2
    routing): the values come out in the stable order by expert."""
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 16, 2 * 2048).astype(np.int32)
    tokens = np.repeat(np.arange(2048, dtype=np.int32), 2)
    (keys, vals), (rkeys, rvals) = sort_kv_both(ids, tokens, 8,
                                                on_overflow="retry")
    assert_bits_equal(keys, rkeys, "keys")
    assert_bits_equal(vals, rvals, "values")
    np.testing.assert_array_equal(keys, np.sort(ids))
    np.testing.assert_array_equal(vals,
                                  tokens[np.argsort(ids, kind="stable")])


def test_sort_kv_rejects_mismatched_values():
    with pytest.raises(ValueError, match="leading dim"):
        tsort.sort_kv(np.arange(8, dtype=np.int32), np.arange(7),
                      tsort.SortSpec(device="cpu", shards=2))


@pytest.mark.parametrize("policy", ["raise", "retry", "spill"])
def test_presorted_argsort_raises_or_recovers(policy):
    """Under "raise" the dense exchange drops keys of presorted input and
    `gather_perm_checked` raises, in both packages; retry and spill give
    the identity permutation, equal to the reference's."""
    x = tdist.make_adversarial("PRESORTED", 8192, seed=1)
    if policy == "raise":                          # 30 + 13 bits: int64
        with pytest.raises(RuntimeError, match="dropped"), \
                jax.enable_x64(True):
            rsort.argsort(x, rsort.SortSpec(mesh=auto_mesh(8)))
        with pytest.raises(RuntimeError, match="dropped"):
            tsort.argsort(x, tsort.SortSpec(device="cpu", shards=8))
        return
    got, want = argsort_both(x, 8, x64=True, on_overflow=policy)
    assert_bits_equal(got, want, "argsort")
    np.testing.assert_array_equal(got, np.arange(x.shape[0]))


def test_gather_perm_checked_checks_the_gathered_length():
    x = tdist.make_adversarial("REVERSE", 8192, seed=1)
    out = tsort.sort(x, tsort.SortSpec(device="cpu", shards=8, stable=True))
    assert int(out.overflow) > 0
    with pytest.raises(RuntimeError, match="dropped"):
        tsort.gather_perm_checked(out, "argsort")
    exact = tsort.sort(x, tsort.SortSpec(device="cpu", shards=8, stable=True,
                                         exchange="allgather"))
    np.testing.assert_array_equal(tsort.gather_perm_checked(exact, "x"),
                                  np.arange(x.shape[0])[::-1])


def test_tag_false_with_argsort_raises():
    x = np.arange(64, dtype=np.int32)
    for fn in (lambda: tsort.argsort(x, tsort.SortSpec(device="cpu",
                                                       tag=False)),
               lambda: tsort.sort_kv(x, x, tsort.SortSpec(device="cpu",
                                                          tag=False))):
        with pytest.raises(ValueError, match="require tagging"):
            fn()
    with pytest.raises(ValueError, match="require tagging"):
        rsort.argsort(x, rsort.SortSpec(mesh=auto_mesh(2), tag=False))


# ----------------------------------------------------------- wide keys
def _int64_keys(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)


WIDE_SORTS = {
    "int64": lambda: _int64_keys(10),
    "int64_small_range": lambda: np.random.default_rng(11).integers(
        -5, 5, N, dtype=np.int64) + 2 ** 40,
    "int64_extreme": lambda: tdist.make_adversarial(
        "DTYPE_EXTREME", N, seed=12, dtype=np.int64),
    "float64": lambda: np.random.default_rng(13).standard_normal(N),
    "float64_extreme": lambda: tdist.make_adversarial(
        "DTYPE_EXTREME", N, seed=14, dtype=np.float64),
    "float64_specials": lambda: _nan_zero_float32(N, 15).astype(np.float64),
}


#: (name, stable) cases that both packages refuse: key bits + tag bits >
#: 62 (int64 max among the keys forces tagging, as a sentinel would).
WIDE_REFUSED = {("int64", True), ("float64", True),
                ("float64_specials", True), ("float64_extreme", True),
                ("int64_extreme", True), ("int64_extreme", False)}


@pytest.mark.parametrize("name", sorted(WIDE_SORTS))
@pytest.mark.parametrize("stable", [False, True])
def test_wide_key_sort_matches_reference(name, stable):
    """Under "retry", so the duplicate-heavy untagged cases end exact."""
    x = WIDE_SORTS[name]()
    if (name, stable) in WIDE_REFUSED:
        for run in (lambda: rsort.sort(x, rsort.SortSpec(
                        mesh=auto_mesh(4), stable=stable)),
                    lambda: tsort.sort(x, tsort.SortSpec(
                        device="cpu", shards=4, stable=stable))):
            with pytest.raises(ValueError, match="> 62"), \
                    jax.enable_x64(True):
                run()
        return
    got, want = sort_both(x, 4, x64=True, stable=stable,
                          on_overflow="retry")
    assert_sort_outputs_equal(got, want, x64=True)
    assert got.shards.dtype == torch.from_numpy(x[:1]).dtype
    assert_bits_equal(got.gather(), x[_stable_order(x)], "gather")


@pytest.mark.parametrize("p", [1, 3])
def test_int64_argsort_and_sort_kv_match_reference(p):
    x = np.random.default_rng(16).integers(0, 1000, N, dtype=np.int64) \
        * 2 ** 33
    got, want = argsort_both(x, p, x64=True)
    assert_bits_equal(got, want, "argsort")
    _check_perm(got, x)
    values = np.arange(N, dtype=np.int64)
    (keys, vals), (rkeys, rvals) = sort_kv_both(x, values, p, x64=True)
    with jax.enable_x64(True):
        assert_bits_equal(keys, rkeys, "keys")
    assert_bits_equal(vals, rvals, "values")


def test_float64_batched_matches_reference():
    xs = np.random.default_rng(17).standard_normal((3, 2051))
    ref_spec = rsort.SortSpec(mesh=auto_mesh(4))
    with jax.enable_x64(True):
        want = rsort.sort_batched(xs, ref_spec)
        want = [want.gather(b) for b in range(3)]
    got = tsort.sort_batched(xs, tsort.SortSpec(device="cpu", shards=4))
    for b in range(3):
        assert_bits_equal(got.gather(b), want[b], f"gather({b})")
        np.testing.assert_array_equal(got.gather(b), np.sort(xs[b]))


# ------------------------------------------------------------- policy
def test_auto_policy_sends_64_bit_keys_to_torch():
    """Under "auto" on the card a 64-bit local sort (and count) takes the
    torch route; 64-bit searches, samples, sends and merges (K4s, K6, K7
    and K5) take the kernels' int64 instantiations."""
    def keys(dtype, device="cuda"):
        """What `route` reads of a key tensor, on a device the CPU lacks."""
        return SimpleNamespace(dtype=dtype, device=torch.device(device),
                               shape=(2, 8))

    route = dispatch.route
    assert route("local_sort", keys(torch.int64)) == "torch"
    assert route("local_sort", keys(torch.float64)) == "torch"
    assert route("probe_ranks.unsorted", keys(torch.int64)) == "torch"
    assert route("local_sort", keys(torch.int32)) == "kernel"
    assert route("local_sort", keys(torch.int32, "cpu")) == "torch"
    assert route("local_sort", keys(torch.int64), "kernel") == "kernel"
    for spot in ("probe_ranks.sorted", "sample_compact", "dense_send",
                 "merge_runs", "merge_ragged"):
        assert route(spot, keys(torch.int64)) == "kernel"
        assert route(spot, keys(torch.int64, "cpu")) == "torch"
        assert route(spot, keys(torch.int64), "torch") == "torch"


def test_explicit_kernel_policy_on_int64_raises():
    """Under "kernel" a 64-bit local sort (K1-K3) and a 64-bit count (K4)
    raise; 64-bit searches (K4s) and merges (K5) run, here as their plain
    versions, and give torch's bits."""
    rows = torch.arange(64, dtype=torch.int64).reshape(2, 32)
    with pytest.raises(TypeError, match="K1-K3"):
        dispatch.local_sort(rows, policy="kernel")
    with pytest.raises(TypeError, match="int32"):
        dispatch.probe_ranks(rows, rows[:, :4], policy="kernel",
                             assume_sorted=False)
    probes = rows[:, ::5] + 1
    assert torch.equal(
        dispatch.probe_ranks(rows, probes, policy="kernel",
                             assume_sorted=True),
        torch.searchsorted(rows, probes).to(torch.int32))
    runs = rows.reshape(2, 4, 8)
    assert torch.equal(dispatch.merge_runs(runs, policy="kernel"),
                       torch.sort(rows, dim=-1).values)
    with pytest.raises(TypeError, match="int32"):
        tsort.sort(np.arange(64, dtype=np.float64),
                   tsort.SortSpec(device="cpu", shards=2,
                                  kernel_policy="kernel"))
    # auto sorts them on the torch route
    out = tsort.sort(np.arange(64, dtype=np.int64)[::-1].copy(),
                     tsort.SortSpec(device="cpu", shards=2))
    np.testing.assert_array_equal(out.gather(), np.arange(64))


def test_package_exports_the_front_doors():
    for name in ("argsort", "sort_kv", "RecoveryStats",
                 "gather_perm_checked", "available_algorithms"):
        assert getattr(repro_torch, name) is getattr(tsort, name)
    assert repro_torch.sort is tsort          # still the subpackage
