"""Kernel parity: the port's plain versions against the Pallas kernels.

Each CUDA kernel of the port has a plain PyTorch version that its wrapper
runs on a CPU tensor. Here those plain versions are held, with zero
tolerance, to the reference's Pallas kernels in interpret mode
(`interpret=True`, as tests/test_kernels.py and tests/test_merge_kernel.py
call them): #1 sort_blocks, #3 merge_adjacent, #5 probe_ranks_pallas,
#7 strided_compare_exchange and #8 merge_bitonic_blocks — with sentinel
tails, duplicates, unsorted keys for #5, and the merge cascade above the
port's shared-memory threshold.

The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_cuda.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitonic_sort import kernel as rbk
from repro.kernels.histogram import kernel as rhk
from repro.kernels.merge import kernel as rmk
from repro.kernels.merge import ops as rmops
from repro_torch.kernels.bitonic_sort import kernel as tbk
from repro_torch.kernels.bitonic_sort import ops as tbops
from repro_torch.kernels.bitonic_sort import ref as tbref
from repro_torch.kernels.histogram import kernel as thk
from repro_torch.kernels.merge import kernel as tmk
from repro_torch.kernels.merge import ops as tmops
from repro_torch.kernels.merge import ref as tmref

INT_MAX = np.iinfo(np.int32).max


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


def _rows(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


KINDS = ["wide", "dups", "sentinel_tail"]


# ------------------------------------------------------- #1 sort_blocks
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block", [2, 64, 1024])
def test_sort_blocks_matches_pallas(rng, kind, block):
    x = _keys(rng, (2, 2 * block), kind)
    want = rbk.sort_blocks(jnp.asarray(x.reshape(-1)), block, interpret=True)
    got = tbk.sort_blocks(_rows(x), block)
    _eq(got, np.asarray(want).reshape(2, -1))
    _eq(got, tbref.block_sort_ref(_rows(x), block))


# ---------------------------------------------------- #3 merge_adjacent
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("run", [1, 32, 512])
def test_merge_adjacent_matches_pallas(rng, kind, run):
    x = _sorted_runs(_keys(rng, (2, 8 * run), kind), run)
    want = rbk.merge_adjacent(jnp.asarray(x.reshape(-1)), run,
                              interpret=True)
    got = tbk.merge_adjacent(_rows(x), run)
    _eq(got, np.asarray(want).reshape(2, -1))
    _eq(got, tbref.merge_pass_ref(_rows(x), run))


# ---------------------------------------------- #8 merge_bitonic_blocks
@pytest.mark.parametrize("block", [2, 64, 1024])
def test_merge_bitonic_blocks_matches_pallas(rng, block):
    half = _sorted_runs(_keys(rng, (2, 4 * block)), block // 2)
    y = half.reshape(2, -1, 2, block // 2)
    x = np.concatenate([y[:, :, 0], y[:, :, 1, ::-1]], axis=-1).reshape(2, -1)
    want = rmk.merge_bitonic_blocks(jnp.asarray(x.reshape(-1)), block,
                                    interpret=True)
    _eq(tmk.merge_bitonic_blocks(_rows(x), block),
        np.asarray(want).reshape(2, -1))


# ------------------------------------------ #7 strided_compare_exchange
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [1, 16, 2048])
def test_strided_compare_exchange_matches_pallas(rng, kind, d):
    x = _keys(rng, (2, 4 * d), kind)
    want = rmk.strided_compare_exchange(jnp.asarray(x.reshape(-1)), d,
                                        cols=min(d, 1024), interpret=True)
    _eq(tmk.strided_compare_exchange(_rows(x), d),
        np.asarray(want).reshape(2, -1))


@pytest.mark.parametrize("d", [1, 4, 256])
def test_flipped_step_is_relayout_then_step(rng, d):
    """flip=True equals the reference's relayout (second d-run reversed,
    merge/kernel.py:93-95) followed by the Pallas step."""
    x = _keys(rng, (2, 8 * d))
    y = x.reshape(2, -1, 2, d)
    xb = np.concatenate([y[:, :, 0], y[:, :, 1, ::-1]], axis=-1)
    want = rmk.strided_compare_exchange(jnp.asarray(xb.reshape(-1)), d,
                                        cols=min(d, 1024), interpret=True)
    _eq(tmk.strided_compare_exchange(_rows(x), d, flip=True),
        np.asarray(want).reshape(2, -1))


@pytest.mark.parametrize("run,smem", [(64, 64), (256, 32), (512, 128)])
def test_merge_pass_hbm_matches_pallas(rng, run, smem):
    x = _sorted_runs(_keys(rng, (2, 4 * run), "dups"), run)
    want = rmk.merge_pass_hbm(jnp.asarray(x.reshape(-1)), run,
                              vmem_block=smem, cols=min(run, 1024),
                              interpret=True)
    _eq(tmk.merge_pass_hbm(_rows(x), run, smem_block=smem),
        np.asarray(want).reshape(2, -1))


@functools.cache
def _cascade_case():
    """Sorted 8-key runs with a sentinel tail, and the Pallas cascade's
    result with a 64-key VMEM threshold (computed once)."""
    x = _sorted_runs(_keys(np.random.default_rng(11), (1, 4096),
                           "sentinel_tail"), 8)
    want = rmops.merge_cascade(jnp.asarray(x.reshape(-1)), 8,
                               vmem_block=64, interpret=True)
    return x, np.asarray(want).reshape(1, -1)


@pytest.mark.parametrize("smem", [16, 256, tbk.SMEM_MAX_SEG])
def test_cascade_above_smem_threshold_matches_pallas(smem):
    """The cascade with the port's shared-memory threshold (and smaller
    ones) against the reference's with its VMEM threshold: the same
    comparators, so the same bits."""
    x, want = _cascade_case()
    _eq(tmops.merge_cascade(_rows(x), 8, smem_block=smem), want)


@pytest.mark.parametrize("k,r", [(3, 50), (8, 128), (5, 1)])
def test_merge_sorted_runs_matches_pallas(rng, k, r):
    runs = np.sort(_keys(rng, (k, r), "dups"), axis=-1)
    want = rmops.merge_sorted_runs(jnp.asarray(runs), vmem_block=32,
                                   interpret=True)
    got = tmops.merge_sorted_runs(torch.from_numpy(runs)[None])
    _eq(got, np.asarray(want)[None])
    _eq(got, tmref.merge_sorted_runs_ref(torch.from_numpy(runs)[None]))


@pytest.mark.parametrize("n", [1, 7, 1000, 4096, 5000])
def test_local_sort_any_length(rng, n):
    x = _keys(rng, (3, n), "dups" if n % 2 else "wide")
    _eq(tbops.local_sort(_rows(x), block=64),
        tbref.local_sort_ref(_rows(x)))


# ------------------------------------------------- #5 probe_ranks_pallas
@pytest.mark.parametrize("n,m", [(512, 16), (1000, 37), (2048, 256)])
@pytest.mark.parametrize("kind", KINDS)
def test_probe_ranks_matches_pallas(rng, n, m, kind):
    """Unsorted keys (the kernel counts, it does not search); the plain
    version pads to the 512-key tile with the hi sentinel as ops.py:17."""
    keys = _keys(rng, (1, n), kind)
    probes = np.sort(_keys(rng, (1, m), kind), axis=-1)
    pad = (-n) % 512
    kp = np.concatenate([keys[0], np.full(pad, INT_MAX, np.int32)])
    want = rhk.probe_ranks_pallas(jnp.asarray(kp), jnp.asarray(probes[0]),
                                  tile=512, interpret=True)
    got = thk.probe_rank_count(_rows(keys), _rows(probes))
    _eq(got, np.asarray(want)[None])


def test_probe_ranks_rows_are_independent(rng):
    keys = _keys(rng, (4, 700))
    probes = np.sort(_keys(rng, (4, 9)), axis=-1)
    got = thk.probe_rank_count(_rows(keys), _rows(probes))
    want = (keys[:, :, None] < probes[:, None, :]).sum(axis=1)
    _eq(got, want.astype(np.int32))


def test_wrappers_validate_arguments():
    with pytest.raises(TypeError):
        tbk.sort_blocks(torch.zeros((1, 8), dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        tbk.sort_blocks(torch.zeros((8,), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        tbk.bitonic_merge_smem(torch.zeros((1, 2 * tbk.SMEM_MAX_SEG),
                                           dtype=torch.int32),
                               2 * tbk.SMEM_MAX_SEG, True)
    with pytest.raises(ValueError):
        tmk.strided_compare_exchange(torch.zeros((1, 12), dtype=torch.int32),
                                     3)
