"""Kernel-policy dispatch: the port's "kernel" and "torch" policies against
`repro.kernels.dispatch` under "pallas" (interpret mode) and "xla".

Every pairing must give the same bits: local sorts (sentinel tails and
duplicates included), probe ranks with and without `assume_sorted`, and
the post-exchange k-way merge. The port's entry points take rows; the
reference's take one array, so each row is held to one reference call.
Also the port's own rule, written out: where each policy sends each hot
spot by key width, device and row length, and the kernels' counters.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as rd
from repro_torch.kernels import cuda
from repro_torch.kernels import dispatch as td
from torch_parity import auto_on_card  # noqa: F401

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


#: The route of each hot spot, key dtype, device and policy. Each row is
#: (hot spot, dtype): then the route on a CPU tensor under "auto",
#: "kernel" and "torch", then on a CUDA tensor under the same three. The
#: ragged merge's full-sort branch is `merge_ragged.full_sort`.
ROUTE_ROWS = {
    ("local_sort", "int32"): ("torch", "kernel", "torch",
                              "kernel", "kernel", "torch"),
    ("local_sort", "int64"): ("torch", "kernel", "torch",
                              "torch", "kernel", "torch"),
    ("probe_ranks.sorted", "int32"): ("torch", "kernel", "torch",
                                      "kernel", "kernel", "torch"),
    ("probe_ranks.sorted", "int64"): ("torch", "kernel", "torch",
                                      "kernel", "kernel", "torch"),
    ("probe_ranks.unsorted", "int32"): ("torch", "kernel", "torch",
                                        "kernel", "kernel", "torch"),
    ("probe_ranks.unsorted", "int64"): ("torch", "kernel", "torch",
                                        "torch", "kernel", "torch"),
    ("sample_compact", "int32"): ("torch", "kernel", "torch",
                                  "kernel", "kernel", "torch"),
    ("sample_compact", "int64"): ("torch", "kernel", "torch",
                                  "kernel", "kernel", "torch"),
    ("dense_send", "int32"): ("torch", "kernel", "torch",
                              "kernel", "kernel", "torch"),
    ("dense_send", "int64"): ("torch", "kernel", "torch",
                              "kernel", "kernel", "torch"),
    ("merge_runs", "int32"): ("torch", "kernel", "torch",
                              "kernel", "kernel", "torch"),
    ("merge_runs", "int64"): ("torch", "kernel", "torch",
                              "kernel", "kernel", "torch"),
    ("merge_ragged", "int32"): ("torch", "kernel", "torch",
                                "kernel", "kernel", "torch"),
    ("merge_ragged", "int64"): ("torch", "kernel", "torch",
                                "kernel", "kernel", "torch"),
    ("merge_ragged.full_sort", "int32"): ("torch", "kernel", "torch",
                                          "kernel", "kernel", "torch"),
    ("merge_ragged.full_sort", "int64"): ("torch", "kernel", "torch",
                                          "torch", "kernel", "torch"),
}
COLUMNS = [(d, p) for d in ("cpu", "cuda")
           for p in ("auto", "kernel", "torch")]
#: The row ceiling: (hot spot, device, policy, row length, route), int32.
CEILING_ROWS = [
    ("local_sort", "cuda", "auto", 1 << 22, "kernel"),
    ("local_sort", "cuda", "auto", (1 << 22) + 1, "torch"),
    ("local_sort", "cuda", "kernel", (1 << 22) + 1, "kernel"),
    ("merge_ragged.full_sort", "cuda", "auto", 1 << 22, "kernel"),
    ("merge_ragged.full_sort", "cuda", "auto", (1 << 22) + 1, "torch"),
    ("merge_ragged.full_sort", "cuda", "kernel", (1 << 22) + 1, "kernel"),
    ("merge_ragged", "cuda", "auto", (1 << 22) + 1, "kernel"),
]


def _full_sort_route(monkeypatch, rows, policy):
    """The route `dispatch.merge_ragged`'s full-sort branch takes on rows
    ("torch" where the whole merge is `torch.sort`)."""
    branch = {}
    monkeypatch.setattr(td.mops, "merge_ragged_runs",
                        lambda *args, full_sort, **kw: branch.setdefault(
                            "sort", full_sort))
    monkeypatch.setattr(td.bops, "local_sort", lambda x: "kernel")
    td.merge_ragged(rows, None, None, policy=policy)
    got = branch["sort"](rows) if branch else "torch"
    return got if isinstance(got, str) else "torch"


@pytest.mark.parametrize(
    "spot,dtype,device,policy,n,want",
    [(spot, dtype, device, policy, 8, want)
     for (spot, dtype), wants in ROUTE_ROWS.items()
     for (device, policy), want in zip(COLUMNS, wants)]
    + [(spot, "int32", device, policy, n, want)
       for spot, device, policy, n, want in CEILING_ROWS])
def test_routing_table(request, monkeypatch, spot, dtype, device, policy, n,
                       want):
    """`dispatch.route` (and the ragged full-sort branch) against the rule
    written out above; CUDA rows resolve as on the card (`auto_on_card`),
    on row-less CPU tensors."""
    if device == "cuda":
        request.getfixturevalue("auto_on_card")
    rows = torch.zeros((0, n), dtype=getattr(torch, dtype))
    if spot == "merge_ragged.full_sort":
        got = _full_sort_route(monkeypatch, rows, policy)
    else:
        got = td.route(spot, rows, policy)
    assert got == want


def test_kernel_counters_are_the_recorded_names():
    """The launch counters the benchmark and the card tests read, by name;
    the `_i64` launchers are derived, not written out."""
    assert cuda.WIDE == ("probe_rank_search.i64", "merge_path_pairs.i64",
                         "sample_compact.i64", "dense_send.i64")
    assert cuda.COUNTERS == (
        "bitonic_sort_blocks", "bitonic_merge_smem.reverse",
        "bitonic_merge_smem.tail", "strided_compare_exchange",
        "probe_rank_count", "probe_rank_search", "merge_path_pairs",
        "sample_compact", "dense_send", "probe_rank_search.i64",
        "merge_path_pairs.i64", "sample_compact.i64", "dense_send.i64")
    assert cuda.OFF_MAIN_PATH == ("probe_rank_count",)
    assert not any(name.endswith("_i64") for name in cuda.SIGNATURES)


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
