"""k-way merge entry points over rows (counterpart of repro.kernels.merge.ops).

merge_cascade      sorted runs of length `run` in each row -> each row one
                   sorted run, by a pairwise bitonic-merge tree.
merge_sorted_runs  (rows, k, r) sorted runs -> (rows, k*r) sorted rows;
                   the merge after the dense exchange.
cap_to             slice or sentinel-pad rows to a static capacity.

All merges are exact: given sorted runs and sentinel-filled slack, the
output equals a full sort of the same entries bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import hi_sentinel, pow2_ceil
from repro_torch.kernels.bitonic_sort import kernel as BK
from repro_torch.kernels.merge import kernel as MK


def merge_cascade(x: torch.Tensor, run: int, *,
                  smem_block: int = BK.SMEM_MAX_SEG) -> torch.Tensor:
    """Pairwise-merge tree over each row of (rows, n), n a power of two:
    K2 pair merges while 2*run <= smem_block, HBM passes above. Also the
    tail of `bitonic_sort.ops.local_sort`."""
    n = x.shape[1]
    while run < n:
        if 2 * run <= smem_block:
            x = BK.merge_adjacent(x, run)
        else:
            x = MK.merge_pass_hbm(x, run, smem_block=smem_block)
        run *= 2
    return x


def merge_sorted_runs(runs: torch.Tensor, *,
                      smem_block: int = BK.SMEM_MAX_SEG) -> torch.Tensor:
    """Merge the k sorted runs of each row of (rows, k, r) into one sorted
    (rows, k*r) row. k and r need not be powers of two: runs and rows are
    sentinel padded internally and the pad is sliced back off (sentinels
    sort to the tail, so the slice is exact)."""
    rows, k, r = runs.shape
    if k * r == 0:
        return torch.zeros((rows, 0), dtype=runs.dtype, device=runs.device)
    sent = hi_sentinel(runs.dtype)
    k2, r2 = pow2_ceil(k), pow2_ceil(r)
    if r2 != r:
        runs = torch.cat([runs, torch.full((rows, k, r2 - r), sent,
                                           dtype=runs.dtype,
                                           device=runs.device)], dim=2)
    if k2 != k:
        runs = torch.cat([runs, torch.full((rows, k2 - k, r2), sent,
                                           dtype=runs.dtype,
                                           device=runs.device)], dim=1)
    flat = runs.reshape(rows, k2 * r2)
    if k2 == 1:
        return flat[:, :r]
    return merge_cascade(flat, r2, smem_block=smem_block)[:, :k * r]


def cap_to(merged: torch.Tensor, cap: int) -> torch.Tensor:
    """Slice/pad sorted rows to a static capacity (sentinel-filled tail)."""
    rows, n = merged.shape
    if n >= cap:
        return merged[:, :cap]
    return torch.cat([merged, torch.full((rows, cap - n),
                                         hi_sentinel(merged.dtype),
                                         dtype=merged.dtype,
                                         device=merged.device)], dim=1)
