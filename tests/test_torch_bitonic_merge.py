"""K2's schedule against the plain merge network and the Pallas kernels.

The CUDA K2 (`bitonic_merge_smem`) runs the half-cleaner cascade through
two layouts: register steps, lane shuffles and one change of layout
through shared memory. `bitonic_merge_tiled_plain` runs the same schedule
in torch ops. Here it is held bit for bit to `bitonic_merge_plain` at
every power-of-two segment from 2 to 16,384 in both roles (reverse: two
sorted runs merged, Pallas #3/#4; tail: an HBM pass's tail, Pallas #8),
and up to 2,048 keys also to the reference's `merge_adjacent` and
`merge_bitonic_blocks` in interpret mode. Inputs are made from a seed with
numpy: an odd row count with an all-INT_MAX row, a duplicate-heavy row and
INT_MIN keys. The tolerance is zero.

    PYTHONPATH=src python -m pytest -q tests/test_torch_bitonic_merge.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitonic_sort import kernel as rbk
from repro.kernels.merge import kernel as rmk
from repro_torch.kernels.bitonic_sort import kernel as tbk

I32 = np.iinfo(np.int32)
SEGMENTS = [1 << j for j in range(1, 15)]      # 2 .. SMEM_MAX_SEG
ROLES = ["reverse", "tail"]


def _merge_rows(rng, rows, n, seg):
    """Sorted runs of seg/2 keys: random, all INT_MAX, duplicates, INT_MIN
    among INT_MAX and small keys; the last row unsorted."""
    x = rng.integers(I32.min, I32.max, size=(rows, n), dtype=np.int64)
    x[1] = I32.max
    x[2] = rng.integers(0, 4, size=n)
    x[3] = rng.choice([I32.min, I32.max, 0, 1, 2], size=n)
    head = x[:-1].reshape(rows - 1, n // (seg // 2), seg // 2)
    x[:-1] = np.sort(head, axis=-1).reshape(rows - 1, n)
    return x.astype(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("seg", SEGMENTS)
def test_tiled_schedule_matches_plain(rng, seg, role):
    x = torch.from_numpy(_merge_rows(rng, 5, max(2 * seg, 64), seg))
    reverse = role == "reverse"
    _eq(tbk.bitonic_merge_tiled_plain(x, seg, reverse),
        tbk.bitonic_merge_plain(x, seg, reverse))


@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("seg", [s for s in SEGMENTS if s <= 2048])
def test_tiled_schedule_matches_pallas(rng, seg, role):
    rows, n = 5, 2 * seg
    x = _merge_rows(rng, rows, n, seg)
    flat = jnp.asarray(x.reshape(-1))
    if role == "reverse":
        want = rbk.merge_adjacent(flat, seg // 2, interpret=True)
    else:
        want = rmk.merge_bitonic_blocks(flat, seg, interpret=True)
    got = tbk.bitonic_merge_tiled_plain(torch.from_numpy(x), seg,
                                        role == "reverse")
    _eq(got, np.asarray(want).reshape(rows, n))


@pytest.mark.parametrize("seg", SEGMENTS)
def test_merge_layout(seg):
    """K keys for each of T threads: whole segments per warp up to 1,024
    keys (T <= 32, one layout), 32 keys a thread and whole warps above."""
    keys, threads = tbk.merge_layout(seg)
    assert keys * threads == seg and keys >= 2
    if seg <= 1024:
        assert threads <= 32
    else:
        assert keys == tbk.MERGE_KEYS and threads % 32 == 0
