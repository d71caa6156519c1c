"""Batched kernels and dispatch: the port against the reference's batched
Pallas kernels (interpret mode) and batched dispatch, at zero tolerance.

The reference's batched kernels compute per row what the unbatched ones
compute, and the port's kernels already take rows, so each batched Pallas
site is held to the same plain version with many rows:

  #2 sort_blocks_batched         -> K1 `sort_blocks` over B rows
  #4 merge_adjacent_batched      -> K2 `merge_adjacent` over B rows
  #6 probe_ranks_batched_pallas  -> K4 `probe_rank_count`, per-row probes

with sentinel tails, duplicates and distinct probe rows per row. Also here:
`dispatch`'s batched entry points under "kernel" and "torch" against the
reference's under "pallas" and "xla", the row-batched merge helpers
(`merge_sorted_runs_batched`, `gather_runs`, `cap_to` over rows) and the
copy of `group_by_length`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as rd
from repro.kernels.bitonic_sort import kernel as rbk
from repro.kernels.bitonic_sort import ops as rbops
from repro.kernels.histogram import kernel as rhk
from repro.kernels.histogram import ops as rhops
from repro.kernels.merge import ops as rmops
from repro.sort.grouping import group_by_length as ref_group_by_length
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.bitonic_sort import kernel as tbk
from repro_torch.kernels.bitonic_sort import ops as tbops
from repro_torch.kernels.histogram import kernel as thk
from repro_torch.kernels.histogram import ops as thops
from repro_torch.kernels.merge import ops as tmops
from repro_torch.sort.grouping import group_by_length
from torch_parity import auto_on_card  # noqa: F401

INT_MAX = np.iinfo(np.int32).max
KINDS = ["wide", "dups", "sentinel_tail"]
PAIRS = [("kernel", "pallas"), ("torch", "xla")]


def _keys(rng, shape, kind="wide"):
    if kind == "dups":
        return rng.integers(0, 8, size=shape).astype(np.int32)
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, size=shape).astype(np.int32)
    if kind == "sentinel_tail":
        x[..., -(shape[-1] // 4):] = INT_MAX
    return x


def _sorted_runs(x, run):
    rows, n = x.shape
    return np.sort(x.reshape(rows, n // run, run), axis=-1).reshape(rows, n)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------ #2 sort_blocks_batched
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block", [2, 128, 1024])
def test_sort_blocks_batched_matches_pallas(rng, kind, block):
    x = _keys(rng, (5, 2 * block), kind)
    want = rbk.sort_blocks_batched(jnp.asarray(x), block, interpret=True)
    _eq(tbk.sort_blocks(torch.from_numpy(x), block), want)


# --------------------------------------------- #4 merge_adjacent_batched
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("run", [1, 64, 512])
def test_merge_adjacent_batched_matches_pallas(rng, kind, run):
    x = _sorted_runs(_keys(rng, (5, 4 * run), kind), run)
    want = rbk.merge_adjacent_batched(jnp.asarray(x), run, interpret=True)
    _eq(tbk.merge_adjacent(torch.from_numpy(x), run), want)


# ----------------------------------------- #6 probe_ranks_batched_pallas
@pytest.mark.parametrize("n,m", [(512, 16), (1000, 37), (2048, 256)])
@pytest.mark.parametrize("kind", KINDS)
def test_probe_ranks_batched_matches_pallas(rng, n, m, kind):
    """Distinct probe rows per key row, unsorted keys; the reference's
    accumulator resets per row, the port's rows add into zeroed outputs."""
    rows = 6
    keys = _keys(rng, (rows, n), kind)
    probes = np.sort(_keys(rng, (rows, m), kind), axis=-1)
    pad = (-n) % 512
    kp = np.concatenate([keys, np.full((rows, pad), INT_MAX, np.int32)],
                        axis=1)
    want = rhk.probe_ranks_batched_pallas(jnp.asarray(kp),
                                          jnp.asarray(probes), tile=512,
                                          interpret=True)
    _eq(thk.probe_rank_count(torch.from_numpy(keys),
                             torch.from_numpy(probes)), want)


@pytest.mark.parametrize("n", [512, 1000])
def test_probe_ranks_batched_ops_match_reference(rng, n):
    """The ops layer: the reference pads each row to the tile itself."""
    keys = _keys(rng, (4, n), "sentinel_tail")
    probes = np.sort(_keys(rng, (4, 33)), axis=-1)
    want = rhops.probe_ranks_batched(jnp.asarray(keys), jnp.asarray(probes),
                                     interpret=True)
    _eq(thops.probe_ranks_batched(torch.from_numpy(keys),
                                  torch.from_numpy(probes)), want)


def test_probe_ranks_batched_leading_axes(rng):
    keys = _keys(rng, (3, 4, 300), "dups")
    probes = np.sort(_keys(rng, (3, 4, 9), "dups"), axis=-1)
    got = thops.probe_ranks_batched(torch.from_numpy(keys),
                                    torch.from_numpy(probes))
    want = (keys[..., :, None] < probes[..., None, :]).sum(axis=-2)
    _eq(got, want.astype(np.int32))
    with pytest.raises(ValueError):
        thops.probe_ranks_batched(torch.from_numpy(keys),
                                  torch.from_numpy(probes[:2]))


@pytest.mark.parametrize("n", [1000, 2048])
def test_local_sort_batched_ops_match_reference(rng, n):
    """#2 and #4 through the reference's batched local sort (interpret
    mode) against the port's, on rows with sentinel tails."""
    x = _keys(rng, (3, n), "sentinel_tail")
    want = rbops.local_sort_batched(jnp.asarray(x), block=64, interpret=True)
    _eq(tbops.local_sort_batched(torch.from_numpy(x), block=64), want)


# ---------------------------------------------------------- dispatch
@pytest.mark.parametrize("port,ref", PAIRS)
@pytest.mark.parametrize("n,kind", [(1000, "wide"), (2048, "dups"),
                                    (777, "sentinel_tail")])
def test_local_sort_batched_matches_reference(rng, port, ref, n, kind):
    x = _keys(rng, (4, n), kind)
    want = rd.local_sort_batched(jnp.asarray(x), policy=ref)
    got = td.local_sort_batched(torch.from_numpy(x), policy=port)
    _eq(got, want)
    # leading axes (the engine's (p, B)) flatten to rows
    _eq(td.local_sort_batched(torch.from_numpy(x).reshape(2, 2, n),
                              policy=port).reshape(4, n), want)


@pytest.mark.parametrize("port,ref", PAIRS)
@pytest.mark.parametrize("assume_sorted", [True, False])
def test_probe_ranks_batched_matches_reference(rng, port, ref,
                                               assume_sorted):
    keys = _keys(rng, (3, 1500), "dups")
    if assume_sorted:
        keys = np.sort(keys, axis=-1)
    probes = np.sort(_keys(rng, (3, 40), "dups"), axis=-1)
    want = rd.probe_ranks_batched(jnp.asarray(keys), jnp.asarray(probes),
                                  policy=ref, assume_sorted=assume_sorted)
    got = td.probe_ranks_batched(torch.from_numpy(keys),
                                 torch.from_numpy(probes), policy=port,
                                 assume_sorted=assume_sorted)
    assert got.dtype == torch.int32
    _eq(got, want)


def test_probe_ranks_batched_empty_probes(rng):
    keys = torch.from_numpy(_keys(rng, (2, 3, 10)))
    got = td.probe_ranks_batched(keys, torch.zeros((2, 3, 0),
                                                   dtype=torch.int32))
    assert got.shape == (2, 3, 0) and got.dtype == torch.int32


@pytest.mark.parametrize("port,ref", PAIRS)
@pytest.mark.parametrize("k,r", [(8, 96), (3, 64), (4, 1)])
def test_merge_runs_batched_matches_reference(rng, port, ref, k, r):
    runs = np.sort(_keys(rng, (3, k, r), "dups"), axis=-1)
    runs[:, :, r - r // 3:] = INT_MAX       # sentinel-padded run tails
    want = rd.merge_runs_batched(jnp.asarray(runs), policy=ref)
    _eq(td.merge_runs_batched(torch.from_numpy(runs), policy=port), want)


def test_auto_policy_row_ceiling(monkeypatch, auto_on_card):
    """AUTO_SORT_MAX_N applies to the row length, as in the reference:
    with "auto" resolving to the kernels (as on the card), a longer row
    goes to torch.sort and a shorter one to the kernels."""
    def kernels_called(x):
        raise AssertionError("kernel path")

    monkeypatch.setattr(td.bops, "local_sort", kernels_called)
    long_rows = torch.zeros((2, td.AUTO_SORT_MAX_N + 1), dtype=torch.int32)
    assert td.local_sort_batched(long_rows).shape == long_rows.shape
    with pytest.raises(AssertionError, match="kernel path"):
        td.local_sort_batched(torch.zeros((2, 8), dtype=torch.int32))


# ------------------------------------------------------ merge helpers
def test_merge_sorted_runs_batched_matches_pallas(rng):
    runs = np.sort(_keys(rng, (3, 5, 50), "dups"), axis=-1)
    want = rmops.merge_sorted_runs_batched(jnp.asarray(runs), vmem_block=32,
                                           interpret=True)
    got = tmops.merge_sorted_runs_batched(torch.from_numpy(runs))
    _eq(got, want)


def test_gather_runs_matches_reference(rng):
    rows, cap, k, slot = 3, 200, 4, 64
    buf = _keys(rng, (rows, cap))
    starts = rng.integers(0, cap, (rows, k)).astype(np.int32)
    counts = rng.integers(0, 80, (rows, k)).astype(np.int32)  # some > slot
    want = jax.vmap(rmops.gather_runs, in_axes=(0, 0, 0, None))(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(counts), slot)
    got = tmops.gather_runs(torch.from_numpy(buf), torch.from_numpy(starts),
                            torch.from_numpy(counts), slot)
    _eq(got, want)


@pytest.mark.parametrize("cap", [30, 64, 100])
def test_cap_to_rows_matches_reference(rng, cap):
    merged = np.sort(_keys(rng, (3, 64)), axis=-1)
    want = rmops._cap_rows_to(jnp.asarray(merged), cap)
    _eq(tmops.cap_to(torch.from_numpy(merged), cap), want)


# ---------------------------------------------------- group_by_length
@pytest.mark.parametrize("multiple,max_groups", [
    (1, 0), (1, 2), (8, 0), (8, 2), (1, 10), (16, 1)])
def test_group_by_length_matches_reference(rng, multiple, max_groups):
    lengths = [5, 9, 5, 33, 17, 9, 64, 1, 33, 5]
    seqs = [np.zeros(n, np.int32) for n in lengths]
    want = ref_group_by_length(seqs, multiple=multiple,
                               max_groups=max_groups)
    got = group_by_length(seqs, multiple=multiple, max_groups=max_groups)
    assert got == want
    assert list(got) == list(want)        # same key order
    tensors = [torch.zeros(n, dtype=torch.int32) for n in lengths]
    assert group_by_length(tensors, multiple=multiple,
                           max_groups=max_groups) == want


def test_group_by_length_edges():
    assert group_by_length([]) == {} == ref_group_by_length([])
    same = [[0] * 4] * 5
    assert group_by_length(same, max_groups=3) == {4: [0, 1, 2, 3, 4]}
    with pytest.raises(ValueError):
        group_by_length(same, multiple=0)
