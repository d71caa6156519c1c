"""The ragged exchange (the exact alltoallv) and its merge.

The reference cannot run its ragged exchange on the CPU (XLA:CPU lacks the
ragged_all_to_all opcode, repro/core/exchange.py:17-19), so the port's
`exchange="ragged"` is held bit for bit to the reference's allgather
exchange (both exact: the same keys land on the same shards) and to
np.sort, on uniform and presorted keys, batched and unbatched, under HSS
and multistage. `merge_ragged_runs` and its batched form are held to the
reference's Pallas merge in interpret mode, on both branches (the merge
tree and the full sort past the slot). Also: `Comm.ragged_all_to_all`
against a loop, the collective log against the reference's contract, and
what the port does where the reference leaves the case to the TPU
runtime — received keys past out_cap are cut at the buffer's end and
counted as overflow.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.sort as tsort
from repro.kernels.merge import ops as rmops
from repro_torch.core import exchange as tex
from repro_torch.data import distributions as tdist
from repro_torch.kernels import dispatch
from repro_torch.kernels.bitonic_sort import ops as tbops
from repro_torch.kernels.merge import ops as tmops
from repro_torch.parallel.comm import Comm
from torch_parity import (
    assert_batched_outputs_equal, assert_bits_equal,
    assert_sort_outputs_equal, random_keys, sort_batched_both, sort_both)

rex = importlib.import_module("repro.core.exchange")

INT_MAX = np.iinfo(np.int32).max
RAGGED = {"exchange": "ragged"}


def _ragged_rows(rng, cap, counts):
    """(rows, cap) int32 buffers holding sorted runs of `counts` back to
    back, INT_MAX elsewhere; -> (buf, starts, counts)."""
    counts = np.asarray(counts, np.int32)
    starts = (np.cumsum(counts, axis=1) - counts).astype(np.int32)
    buf = np.full((counts.shape[0], cap), INT_MAX, np.int32)
    for r in range(counts.shape[0]):
        for s, c in zip(starts[r], counts[r]):
            buf[r, s:s + c] = np.sort(rng.integers(-2 ** 31, INT_MAX, c))
    return buf, starts, counts


@pytest.mark.parametrize("slot", [128, 32])
def test_merge_ragged_matches_pallas(rng, slot):
    """slot 128 fits every run (the merge tree); slot 32 does not (the
    full sort). Each row against the reference's merge in interpret
    mode, and the batched form against its batched merge."""
    buf, starts, counts = _ragged_rows(
        rng, 256, [[37, 0, 1, 80, 0, 23], [100, 4, 60, 0, 0, 1]])
    tmops.ragged_branches.clear()
    got = tmops.merge_ragged_runs(torch.from_numpy(buf),
                                  torch.from_numpy(starts),
                                  torch.from_numpy(counts), slot=slot,
                                  full_sort=tbops.local_sort)
    branch = "merge_tree" if slot == 128 else "full_sort"
    assert dict(tmops.ragged_branches) == {branch: 1}
    for r in range(2):
        want = rmops.merge_ragged_runs(
            jnp.asarray(buf[r]), jnp.asarray(starts[r]),
            jnp.asarray(counts[r]), slot=slot, interpret=True)
        assert_bits_equal(got[r], np.asarray(want), f"row {r}")
    want = rmops.merge_ragged_runs_batched(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(counts),
        slot=slot, interpret=True)
    assert_bits_equal(got, np.asarray(want), "batched")


@pytest.mark.parametrize("policy", ["kernel", "torch"])
def test_dispatch_merge_ragged_is_a_sort(rng, policy):
    buf, starts, counts = _ragged_rows(rng, 300, [[50, 70, 0, 9]] * 3)
    got = dispatch.merge_ragged(torch.from_numpy(buf),
                                torch.from_numpy(starts),
                                torch.from_numpy(counts), policy=policy,
                                slot=64)
    assert_bits_equal(got, np.sort(buf, axis=1), policy)
    assert dispatch.merge_ragged_batched is dispatch.merge_ragged


def test_ragged_all_to_all_matches_a_loop(rng):
    """Chunks of any size, empty ones included, land back to back in
    source order; slots past the last chunk keep the output's fill."""
    p, batch, n, cap = 3, 2, 10, 24
    operand = torch.from_numpy(rng.integers(0, 1000, (p, batch, n))
                               .astype(np.int32))
    sizes = rng.integers(0, 5, (p, batch, p)).astype(np.int32)
    sizes[0, 0, 1] = 0
    starts = rng.integers(0, n - 4, (p, batch, p)).astype(np.int32)
    # destination d's buffer: source 0's chunk, then source 1's, ...
    offsets = (np.cumsum(sizes, axis=0) - sizes).astype(np.int32)
    fill = torch.full((p, batch, cap), -1, dtype=torch.int32)
    comm = Comm(p)
    got = comm.ragged_all_to_all(operand, fill, torch.from_numpy(starts),
                                 torch.from_numpy(sizes),
                                 torch.from_numpy(offsets))
    want = np.full((p, batch, cap), -1, np.int32)
    for s in range(p):
        for b in range(batch):
            for d in range(p):
                o, c, a = offsets[s, b, d], sizes[s, b, d], starts[s, b, d]
                want[d, b, o:o + c] = operand[s, b, a:a + c].numpy()
    assert_bits_equal(got, want, "ragged_all_to_all")
    assert dict(comm.log) == {"ragged_all_to_all": 1}


@pytest.mark.parametrize("p,dtype", [(2, np.int32), (3, np.uint32),
                                     (4, np.float32), (8, np.int32)])
def test_sort_equals_reference_allgather(p, dtype):
    x = random_keys(dtype, p * 2048 + 7, seed=p)
    got, want = sort_both(x, p, RAGGED, exchange="allgather", tag=False)
    assert_sort_outputs_equal(got, want)
    assert int(got.overflow) == 0
    np.testing.assert_array_equal(got.gather(), np.sort(x))


@pytest.mark.parametrize("name", ["PRESORTED", "REVERSE"])
def test_presorted_equals_reference_allgather(name):
    """Each shard's run goes to one destination and is longer than the
    merge's slot: the full-sort branch, exact where dense drops keys."""
    x = tdist.make_adversarial(name, 8 * 2048, seed=0)
    tmops.ragged_branches.clear()
    got, want = sort_both(x, 8, {"exchange": "ragged",
                                 "kernel_policy": "kernel"},
                          exchange="allgather", tag=False)
    assert dict(tmops.ragged_branches) == {"full_sort": 1}
    assert_sort_outputs_equal(got, want)
    np.testing.assert_array_equal(got.gather(), np.sort(x))
    dense = tsort.sort(x, tsort.SortSpec(shards=8, device="cpu", tag=False))
    assert int(dense.overflow) > 0


@pytest.mark.parametrize("policy", ["auto", "kernel"])
def test_sort_batched_equals_reference_allgather(policy):
    xs = random_keys(np.int32, (3, 4 * 2048), seed=9)
    got, want = sort_batched_both(xs, 4, {"exchange": "ragged",
                                          "kernel_policy": policy},
                                  exchange="allgather", tag=False)
    assert_batched_outputs_equal(got, want)


def test_multistage_equals_reference_allgather():
    x = random_keys(np.int32, 8 * 2048, seed=4)
    got, want = sort_both(x, 8, RAGGED, algorithm="multistage",
                          exchange="allgather", tag=False)
    assert_sort_outputs_equal(got, want)


def test_equals_the_ports_allgather():
    x = random_keys(np.int32, 4 * 2048, seed=2)
    spec = tsort.SortSpec(shards=4, device="cpu", tag=False,
                          kernel_policy="kernel")
    a = tsort.sort(x, spec, exchange="ragged")
    b = tsort.sort(x, spec, exchange="allgather")
    for name in ("shards", "counts", "splitter_keys", "overflow"):
        assert_bits_equal(getattr(a, name), getattr(b, name), name)


def test_collectives_match_the_contract():
    """Two all_to_alls and one ragged_all_to_all, as the reference; and
    one psum, the truncation count the reference lacks. One call each
    whatever B is."""
    p = 4
    rows = torch.sort(torch.from_numpy(
        random_keys(np.int32, (p, 3, 256), seed=1)), dim=-1).values
    keys = torch.sort(torch.from_numpy(
        random_keys(np.int32, (3, p - 1), seed=2)), dim=-1).values
    comm = Comm(p)
    tex.exchange_batched(rows, keys, comm=comm,
                         cfg=tex.ExchangeConfig(strategy="ragged"))
    want = rex.EXCHANGE_COLLECTIVES["ragged"]
    got = tex.EXCHANGE_COLLECTIVES["ragged"]
    assert {k: v for k, v in got.items() if k != "psum"} == {
        k: v for k, v in want.items() if k != "psum"}
    assert got["psum"] == want["psum"] + 1
    assert dict(comm.log) == {k: v for k, v in got.items() if v}


def test_past_out_cap_is_cut_and_counted(rng):
    """Splitters that send every key to destination 0: the buffer takes
    the first out_cap keys in source order, sorted; the rest are cut at
    its end, counted in n_valid's place and in the overflow."""
    p, n = 4, 256
    rows = np.sort(rng.integers(-1000, 1000, (p, 1, n)), axis=-1).astype(
        np.int32)
    keys = torch.full((1, p - 1), INT_MAX, dtype=torch.int32)
    cfg = tex.ExchangeConfig(strategy="ragged", kernel_policy="kernel")
    out, n_valid, overflow = tex.exchange_batched(
        torch.from_numpy(rows), keys, comm=Comm(p), cfg=cfg, eps=0.05)
    out_cap = cfg.out_cap(n, p, 0.05)
    assert out.shape == (p, 1, out_cap)
    kept = rows[:, 0].reshape(-1)[:out_cap]
    assert_bits_equal(out[0, 0], np.sort(kept), "destination 0")
    assert n_valid[:, 0].tolist() == [out_cap, 0, 0, 0]
    assert int(overflow[0]) == p * n - out_cap
    assert bool((out[1:] == INT_MAX).all())


def test_truncation_makes_retry_escalate():
    """sample_random's default sizing at 16,384 keys breaks the balance:
    under raise the ragged exchange reports the cut keys as overflow (the
    gather is short by exactly that many); retry ends exact."""
    x = np.random.default_rng(0).permutation(8 * 2048).astype(np.int32)
    spec = tsort.SortSpec(shards=8, device="cpu", tag=False,
                          algorithm="sample_random", exchange="ragged")
    raised = tsort.sort(x, spec)
    assert int(raised.overflow) == x.shape[0] - raised.gather().shape[0] > 0
    out = tsort.sort(x, spec, on_overflow="retry")
    assert out.recovery.attempts > 1
    np.testing.assert_array_equal(out.gather(), np.sort(x))


def test_unknown_exchange_raises():
    with pytest.raises(ValueError, match="unknown exchange"):
        tsort.sort(np.arange(64, dtype=np.int32),
                   tsort.SortSpec(shards=2, device="cpu", exchange="mpi"))
