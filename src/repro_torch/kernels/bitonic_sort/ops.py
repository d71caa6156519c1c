"""The local sort built from the bitonic kernels, over rows.

`local_sort(x)` sorts each row of a (rows, n) int32 tensor: pad the rows
to a power of two with the hi sentinel, sort `block`-key runs with K1,
then merge runs pairwise (`merge.ops.merge_cascade`: K2 while a pair fits
in shared memory, the strided HBM pass above it). Counterpart of
`repro.kernels.bitonic_sort.ops.local_sort` (ops.py:42), with the shard
axis written out as rows.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import hi_sentinel, pow2_ceil
from repro_torch.kernels.bitonic_sort import kernel as K

DEFAULT_BLOCK = 1024


def local_sort(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Full sort of each row: kernel block sort + kernel merge cascade."""
    # deferred: merge.ops imports the bitonic kernels too
    from repro_torch.kernels.merge.ops import merge_cascade

    rows, n = x.shape
    np2 = pow2_ceil(max(n, 2))
    blk = min(block, np2)
    if np2 != n:
        x = torch.cat([x, torch.full((rows, np2 - n), hi_sentinel(x.dtype),
                                     dtype=x.dtype, device=x.device)], dim=1)
    x = K.sort_blocks(x, blk)
    x = merge_cascade(x, blk)
    return x if np2 == n else x[:, :n].contiguous()
