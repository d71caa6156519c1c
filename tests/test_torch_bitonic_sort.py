"""K1's schedule against the plain sort network and the Pallas kernels.

The CUDA K1 (`sort_blocks`) keeps a block of up to 1,024 keys in one
warp's registers, min(32, block) consecutive keys a lane, and runs each
stage as a mirror step followed by ascending half-cleaners, in registers
and lane shuffles. `sort_blocks_tiled_plain` runs the same schedule in
torch ops. Here it is held bit for bit to `sort_blocks_plain` at every
power-of-two block from 2 to 1,024, and to the reference's `sort_blocks`
(Pallas #1) and `sort_blocks_batched` (Pallas #2) in interpret mode.
Inputs are made from a seed with numpy: an odd row count with an
all-INT_MAX row, a duplicate-heavy row and INT_MIN among INT_MAX and small
keys. The tolerance is zero.

    PYTHONPATH=src python -m pytest -q tests/test_torch_bitonic_sort.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitonic_sort import kernel as rbk
from repro_torch.kernels.bitonic_sort import kernel as tbk

I32 = np.iinfo(np.int32)
BLOCKS = [1 << j for j in range(1, 11)]        # 2 .. MAX_BLOCK


def _edge_rows(rng, rows, n):
    """Random keys; row 1 all INT_MAX, row 2 duplicates, row 3 INT_MIN
    among INT_MAX and small keys."""
    x = rng.integers(I32.min, I32.max, size=(rows, n), dtype=np.int64)
    x[1] = I32.max
    x[2] = rng.integers(0, 4, size=n)
    x[3] = rng.choice([I32.min, I32.max, 0, 1, 2], size=n)
    return x.astype(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block", BLOCKS)
def test_tiled_schedule_matches_plain(rng, block):
    x = torch.from_numpy(_edge_rows(rng, 5, max(4 * block, 64)))
    _eq(tbk.sort_blocks_tiled_plain(x, block),
        tbk.sort_blocks_plain(x, block))


@pytest.mark.parametrize("block", BLOCKS)
def test_tiled_schedule_matches_pallas(rng, block):
    rows, n = 5, 2 * block
    x = _edge_rows(rng, rows, n)
    got = tbk.sort_blocks_tiled_plain(torch.from_numpy(x), block)
    flat = rbk.sort_blocks(jnp.asarray(x.reshape(-1)), block, interpret=True)
    _eq(got, np.asarray(flat).reshape(rows, n))
    _eq(got, rbk.sort_blocks_batched(jnp.asarray(x), block, interpret=True))
