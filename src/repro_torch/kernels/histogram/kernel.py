"""Probe ranks, the per-round histogram of HSS: K4s searches, K4 counts.

rank[r, m] = #{keys[r, :] < probes[r, m]}, int32. Both kernels replace the
Pallas `probe_ranks_pallas` (repro/kernels/histogram/kernel.py:35) and its
per-row form (:64), which walk key tiles on a sequential grid and carry
one (M,) accumulator from step to step (:25-32).

K4s (`probe_rank_search`) takes rows sorted ascending, which is what every
main-path caller hands it (the splitters rank over locally sorted shards).
One warp searches for one (row, probe) pair, 32-ary: each level its 32
lanes read 32 evenly spaced pivots of the interval that holds the rank,
and one ballot counts those below the probe (a prefix, since the row is
sorted); at 32 keys or fewer one coalesced read finishes. What bounds it
on an H100 is the latency of those dependent loads, ceil(log32 n) of them
(5 for a 2,000,000-key row), not bytes or operations: a comparison search
needs ceil(log2(n+1)) keys per probe, 0.2 MB for the main path's 8 rows x
256 probes. Beside it, `probe_ranks_search_plain` runs the same schedule
in torch ops over all pairs at once. Over int64 rows it runs the same
schedule, INT64_MAX the hi sentinel.

K4 (`probe_rank_count`) takes keys in any order, as the Pallas kernel's
contract allows (its keys "need NOT be sorted"); only
`assume_sorted=False` reaches it. Hopper's thread blocks run in no order,
so nothing can carry over: each block takes one (row, 4096-key tile),
stages the tile in shared memory, lets each thread count its probes over
the tile with broadcast reads, and adds the partial counts into a zeroed
(rows, M) output with atomicAdd — exact in any order, since the counts
are integers. What bounds it: operations. The work is n*M compares plus
the adds that sum them, against n*4 bytes read: for 8 x 2,000,000 keys
and M = 256 probes that is 8.2 G int32 operations (0.24 ms at 33.5 TOPS)
against 64 MB (0.02 ms at 3.35 TB/s). Its plain version,
`probe_ranks_plain`, is the reference's compare-and-sum
(`_probe_rank_kernel`) in torch ops over tiles of `tile` keys, with the
row padded to the tile with the hi sentinel as `histogram/ops.py:17` pads
it. The kernel masks the ragged edge itself (past the row it reads the hi
sentinel), so both compute the same counts.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import hi_sentinel, round_up
from repro_torch.kernels import cuda

#: Key tile of K4's plain version: the reference's DEFAULT_TILE.
DEFAULT_TILE = 512
#: Lanes of a warp: K4s's fan-out per search level.
WARP = 32
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


def _check_args(keys: torch.Tensor, probes: torch.Tensor, what: str):
    cuda.check_rows(keys, what)
    cuda.check_rows(probes, what)
    if probes.dtype != keys.dtype:
        raise TypeError(f"{what}: probes {probes.dtype} and keys "
                        f"{keys.dtype} differ")
    if probes.shape[0] != keys.shape[0] or probes.device != keys.device:
        raise ValueError(
            f"{what}: probes {tuple(probes.shape)} on {probes.device} do "
            f"not match keys {tuple(keys.shape)} on {keys.device}")


def search_levels(n: int) -> int:
    """Pivot levels of the 32-ary search before at most WARP keys are left
    (the widest interval shrinks to ceil(w / 32) per level)."""
    levels = 0
    while n > WARP:
        n = -(-n // WARP)
        levels += 1
    return levels


def probe_ranks_search_plain(keys: torch.Tensor, probes: torch.Tensor
                             ) -> torch.Tensor:
    """K4s's schedule in torch ops, over every (row, probe) pair at once:
    the rank lies in [lo, lo + w]; each level gathers the 32 pivots
    keys[lo + (l+1)s - 1], s = ceil(w / 32) (a pivot past the interval
    counts as not < probe), and moves lo past the c pivots below the
    probe: lo += c*s, w = min(s, lo_old + w_old - lo). Pairs whose w is
    already at most 32 keep it. The last level counts keys[lo + l], l < w.
    Keys sorted ascending in each row; n >= 1."""
    rows, n = keys.shape
    m = probes.shape[1]
    dev = keys.device
    lanes = torch.arange(1, WARP + 1, device=dev)
    lo = torch.zeros((rows, m), dtype=torch.int64, device=dev)
    w = torch.full((rows, m), n, dtype=torch.int64, device=dev)
    pr = probes[..., None]

    def below(idx, valid):
        """How many valid lanes read a key below the probe."""
        got = torch.gather(keys, 1, idx.clamp(max=n - 1).reshape(rows, -1))
        return (valid & (got.reshape(rows, m, WARP) < pr)).sum(-1)

    for _ in range(search_levels(n)):
        s = (w + WARP - 1) // WARP
        off = lanes * s[..., None]
        c = below(lo[..., None] + off - 1, off <= w[..., None])
        live = w > WARP
        nlo = lo + c * s
        w = torch.where(live, torch.minimum(s, lo + w - nlo), w)
        lo = torch.where(live, nlo, lo)
    c = below(lo[..., None] + lanes - 1, lanes <= w[..., None])
    return (lo + c).to(torch.int32)


def probe_rank_search(keys: torch.Tensor, probes: torch.Tensor
                      ) -> torch.Tensor:
    """K4s: (rows, n) int32 or int64 keys sorted ascending in each row,
    (rows, M) probes of the same dtype -> (rows, M) int32 ranks."""
    _check_args(keys, probes, "probe_rank_search")
    rows, n = keys.shape
    m = probes.shape[1]
    if n == 0 or not rows or not m:
        return torch.zeros((rows, m), dtype=torch.int32, device=keys.device)
    if keys.device.type == "cpu":
        return probe_ranks_search_plain(keys, probes)
    out = torch.empty((rows, m), dtype=torch.int32, device=keys.device)
    cuda.launch("probe_rank_search", keys.dtype, keys.data_ptr(),
                probes.data_ptr(), out.data_ptr(), rows, n, m)
    return out


def probe_rank_count(keys: torch.Tensor, probes: torch.Tensor
                     ) -> torch.Tensor:
    """K4: (rows, n) int32 keys, (rows, M) int32 probes -> (rows, M) ranks."""
    _check_args(keys, probes, "probe_rank_count")
    rows, n = keys.shape
    m = probes.shape[1]
    if keys.device.type == "cpu":
        if n == 0:
            return torch.zeros((rows, m), dtype=torch.int32)
        return probe_ranks_plain(keys, probes)
    out = torch.zeros((rows, m), dtype=torch.int32, device=keys.device)
    if rows and n and m:
        cuda.launch("probe_rank_count", keys.dtype, keys.data_ptr(),
                    probes.data_ptr(), out.data_ptr(), rows, n, m)
    return out
