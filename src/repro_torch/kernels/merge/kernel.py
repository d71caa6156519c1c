"""Strided compare-exchange (K3) and the HBM-resident bitonic merge pass.

A bitonic merge of two sorted runs of length R is a fixed comparator
network: relayout the pair into one bitonic sequence (second run
reversed), then a half-cleaner cascade at distances R, R/2, ..., 1. K2
(`bitonic_merge_smem`) runs the whole network on chip while the
pair fits (2R <= SMEM_MAX_SEG). Above that, `merge_pass_hbm` splits the
same network into passes over device memory:

  strided_compare_exchange  K3, one cascade step at distance d, replacing
                            the Pallas `strided_compare_exchange`
                            (repro/kernels/merge/kernel.py:49);
  merge_bitonic_blocks      K2 without the reversal, replacing the Pallas
                            `merge_bitonic_blocks` (same file :71): once
                            2d <= SMEM_MAX_SEG, every remaining comparator
                            lies inside one aligned segment.

K3 is elementwise: one thread per pair (i, i+d), coalesced loads, 16-byte
vectors when d % 4 == 0. What bounds it is memory: 8 bytes read and 8
written per pair, no reuse, so its floor is 2 x bytes / 3.35 TB/s. The
reference's bitonic relayout (an XLA flip at merge/kernel.py:93-95, pure
data movement outside any kernel) would be one more full pass over the
array; here it is folded into the first K3 step (`flip=True` reads each
pair's partner mirrored), which saves that pass.

Both kernels write a new output; the plain version beside K3 is the
reference's `_strided_ce_kernel` in torch ops.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.bitonic_sort.kernel import (
    SMEM_MAX_SEG, bitonic_merge_smem)


def strided_compare_exchange_plain(x: torch.Tensor, d: int,
                                   flip: bool = False) -> torch.Tensor:
    rows, n = x.shape
    y = x.reshape(rows * n // (2 * d), 2, d)
    lo, hi = y[:, 0, :], y[:, 1, :]
    if flip:
        hi = hi.flip(-1)
    return torch.stack([torch.minimum(lo, hi), torch.maximum(lo, hi)],
                       dim=1).reshape(rows, n)


def strided_compare_exchange(x: torch.Tensor, d: int,
                             flip: bool = False) -> torch.Tensor:
    """K3: one ascending compare-exchange at distance `d` over each row of
    (rows, n): (x[i], x[i+d]) <- (min, max) for floor(i/d) even. With
    `flip`, the partner of x[i] is x[i + 2d - 1 - 2(i mod d)], i.e. the
    step runs on the relayout whose second d-run is reversed."""
    cuda.check_int32_rows(x, "strided_compare_exchange")
    if d < 1 or d & (d - 1) or x.shape[1] % (2 * d):
        raise ValueError(f"strided_compare_exchange: distance {d} must be a "
                         f"power of two with 2d dividing {x.shape[1]}")
    if x.device.type == "cpu":
        return strided_compare_exchange_plain(x, d, flip)
    out = torch.empty_like(x)
    if x.numel():
        cuda.launch("strided_compare_exchange", x.data_ptr(), out.data_ptr(),
                    x.numel(), d, int(flip))
    return out


def merge_bitonic_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """Run the cascade at distances block/2 .. 1 within each aligned block."""
    return bitonic_merge_smem(x, block, reverse_second_half=False)


def merge_pass_hbm(x: torch.Tensor, run: int, *,
                   smem_block: int = SMEM_MAX_SEG) -> torch.Tensor:
    """Merge adjacent sorted runs of length `run` (a power of two) in each
    row into sorted runs of 2*run, holding at most `smem_block` keys on
    chip. Needs 2*run > smem_block (smaller pairs merge in one K2)."""
    if 2 * run <= smem_block:
        raise ValueError(f"run {run} fits on chip: use merge_adjacent")
    d, flip = run, True
    while 2 * d > smem_block:
        x = strided_compare_exchange(x, d, flip=flip)
        d, flip = d // 2, False
    return merge_bitonic_blocks(x, 2 * d)
