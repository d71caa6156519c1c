"""The local sort built from the bitonic kernels, over rows.

`local_sort(x)` sorts each row of an int32 tensor (..., n): the leading
axes (shards, or the batched engine's (p, B)) flatten to rows, every row
pads to one shared power of two with the hi sentinel, K1 sorts `block`-key
runs, then runs merge pairwise (`merge.ops.merge_cascade`: K2 while a pair
fits on chip, the strided HBM pass above it). The row boundary is
a run boundary, so no comparator crosses it. Counterpart of the
reference's `local_sort` and `local_sort_batched` (ops.py:42, :61).
"""
from __future__ import annotations

import torch

from repro_torch.core.common import pow2_ceil
from repro_torch.kernels import cuda
from repro_torch.kernels.bitonic_sort import kernel as K
from repro_torch.kernels.merge.ops import cap_to, merge_cascade

DEFAULT_BLOCK = 1024


def local_sort(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Full sort of each row of (..., n): kernel block sort + kernel merge
    cascade, one launch per pass for all rows."""
    if x.dtype not in cuda.KERNELS["bitonic_sort_blocks"].dtypes:
        raise TypeError(f"local_sort: the bitonic kernels K1-K3 sort int32 "
                        f"keys only, got {x.dtype} (64-bit keys sort on "
                        f"torch.sort under kernel_policy 'auto' or 'torch')")
    shape, n = x.shape, x.shape[-1]
    np2 = pow2_ceil(max(n, 2))
    blk = min(block, np2)
    x = K.sort_blocks(cap_to(x.reshape(-1, n), np2), blk)
    x = merge_cascade(x, blk)
    return cap_to(x, n).contiguous().reshape(shape)


#: The reference's batched name; `local_sort` already takes any rows.
local_sort_batched = local_sort
