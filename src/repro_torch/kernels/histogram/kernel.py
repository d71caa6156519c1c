"""Probe-rank count (K4), the per-round histogram of HSS.

rank[r, m] = #{keys[r, :] < probes[r, m]}, int32. The keys need not be
sorted: the kernel counts, it does not search. K4 replaces the Pallas
`probe_ranks_pallas` (repro/kernels/histogram/kernel.py:35), which walks
key tiles on a sequential grid and carries one (M,) accumulator from step
to step (:25-32). Hopper's thread blocks run in no order, so nothing can
carry over: each block takes one (row, 4096-key tile), stages the tile in
shared memory, lets each thread count its probes over the tile with
broadcast reads, and adds the partial counts into a zeroed (rows, M)
output with atomicAdd — exact in any order, since the counts are
integers.

What bounds it on an H100: operations. The work is n*M compares plus the
adds that sum them, against n*4 bytes read: for the main path's 8 x
2,000,000 keys and M = 256 probes that is 8.2 G int32 operations (0.24 ms
at 33.5 TOPS) against 64 MB (0.02 ms at 3.35 TB/s). The design reads every
key from device memory once and keeps the compare loop in shared memory
and registers.

Beside the wrapper is the plain version: the reference's compare-and-sum
(`_probe_rank_kernel`) in torch ops over tiles of `tile` keys, with the
row padded to the tile with the hi sentinel as `histogram/ops.py:17` pads
it. The kernel masks the ragged edge itself (past the row it reads the hi
sentinel), so both compute the same counts.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import hi_sentinel, round_up
from repro_torch.kernels import cuda

#: Key tile of the plain version: the reference's DEFAULT_TILE.
DEFAULT_TILE = 512
#: Elements of the (rows, keys, M) comparison the plain version
#: materializes at once; integer sums are exact in any grouping.
_PLAIN_CHUNK = 1 << 24


def probe_ranks_plain(keys: torch.Tensor, probes: torch.Tensor,
                      tile: int = DEFAULT_TILE) -> torch.Tensor:
    rows, n = keys.shape
    m = probes.shape[1]
    t = min(tile, n)
    npad = round_up(n, t)
    if npad != n:
        keys = torch.cat([keys, torch.full((rows, npad - n),
                                           hi_sentinel(keys.dtype),
                                           dtype=keys.dtype,
                                           device=keys.device)], dim=1)
    acc = torch.zeros((rows, m), dtype=torch.int32, device=keys.device)
    step = t * max(1, _PLAIN_CHUNK // (t * m * rows))
    for start in range(0, npad, step):
        blk = keys[:, start:start + step]
        acc += (blk[:, :, None] < probes[:, None, :]).sum(
            dim=1, dtype=torch.int32)
    return acc


def probe_rank_count(keys: torch.Tensor, probes: torch.Tensor
                     ) -> torch.Tensor:
    """K4: (rows, n) int32 keys, (rows, M) int32 probes -> (rows, M) ranks."""
    cuda.check_int32_rows(keys, "probe_rank_count")
    cuda.check_int32_rows(probes, "probe_rank_count")
    if probes.shape[0] != keys.shape[0] or probes.device != keys.device:
        raise ValueError(
            f"probe_rank_count: probes {tuple(probes.shape)} on "
            f"{probes.device} do not match keys {tuple(keys.shape)} on "
            f"{keys.device}")
    rows, n = keys.shape
    m = probes.shape[1]
    if keys.device.type == "cpu":
        if n == 0:
            return torch.zeros((rows, m), dtype=torch.int32)
        return probe_ranks_plain(keys, probes)
    out = torch.zeros((rows, m), dtype=torch.int32, device=keys.device)
    if rows and n and m:
        cuda.launch("probe_rank_count", keys.data_ptr(), probes.data_ptr(),
                    out.data_ptr(), rows, n, m)
    return out
