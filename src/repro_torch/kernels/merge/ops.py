"""k-way merge entry points over rows (counterpart of repro.kernels.merge.ops).

merge_cascade      sorted runs of length `run` in each row -> each row one
                   sorted run, by a pairwise bitonic-merge tree.
merge_sorted_runs  (..., k, r) sorted runs -> (..., out_len) sorted rows;
                   the merge after the exchange: K5 levels over each run's
                   valid prefix. Leading axes (the batched engine's (p, B))
                   flatten to rows: one launch a level for every request
                   and shard (the reference's merge_sorted_runs_batched,
                   merge/ops.py:105).
gather_runs        runs at traced offsets of each row -> a sentinel-padded
                   (..., k, slot) buffer; the allgather exchange's windows.
merge_ragged_runs  each row holds k sorted runs at traced offsets ->
                   the sorted row; the ragged exchange's merge.
cap_to             slice or sentinel-pad rows to a static capacity (the
                   reference's cap_to and _cap_rows_to in one).

All merges are exact: given sorted runs and sentinel-filled slack, the
output equals a full sort of the same entries bit for bit.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.core.common import hi_sentinel, pow2_ceil
from repro_torch.kernels.bitonic_sort import kernel as BK
from repro_torch.kernels.merge import kernel as MK
from repro_torch.runtime.syncs import sync_site


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
                      counts: torch.Tensor | None = None,
                      out_len: int | None = None) -> torch.Tensor:
    """Merge the k sorted runs of each row of (..., k, r) into one sorted
    row cut or sentinel-padded to out_len (default k*r): `cap_to(sort(row),
    out_len)` bit for bit. `counts` (..., k) says run i's keys are its
    first counts[..., i] slots and the rest hold the hi sentinel, so only
    those prefixes need merging (None: whole runs).

    ceil(log2 k) K5 levels merge the valid prefixes pairwise, the last
    writing the out_len row with its sentinel tail; the levels before it
    leave the slots past each merged count unwritten, since the next level
    reads only the counts' prefixes. A single run is already its row."""
    *lead, k, r = runs.shape
    length = k * r if out_len is None else out_len
    if k * r == 0 or length == 0:
        return torch.full((*lead, length), hi_sentinel(runs.dtype),
                          dtype=runs.dtype, device=runs.device)
    if k == 1:
        return cap_to(runs[..., 0, :], length).contiguous()
    x = runs.reshape(-1, k, r).contiguous()
    c = (None if counts is None
         else counts.reshape(-1, k).to(torch.int32).contiguous())
    while x.shape[1] > 2:
        x, c = MK.merge_path_pairs(x, c, _fill=False)
    return MK.merge_path_pairs(x, c, out_len=length)[0].reshape(*lead, length)


#: The reference's batched name; `merge_sorted_runs` already takes rows.
merge_sorted_runs_batched = merge_sorted_runs


def merge_flat_runs(x: torch.Tensor, run: int) -> torch.Tensor:
    """Merge back-to-back sorted runs of equal length `run` in each row of
    (..., n) (counterpart of merge/ops.py:134): `merge_sorted_runs`, so
    K5 on the card."""
    n = x.shape[-1]
    if run < 1 or n % run:
        raise ValueError(f"row length {n} is not a multiple of run={run}")
    return merge_sorted_runs(x.reshape(x.shape[:-1] + (n // run, run)))


def gather_runs(buf: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, slot: int) -> torch.Tensor:
    """Extract k runs at traced offsets of each row into a sentinel-padded
    (..., k, slot) buffer: buf (..., cap), starts and counts (..., k).
    Slots past counts hold the sentinel; entries of a run beyond `slot`
    are not represented (callers detect counts > slot). Row-batched form
    of the reference's gather_runs (merge/ops.py:152)."""
    cap = buf.shape[-1]
    lead, k = starts.shape[:-1], starts.shape[-1]
    pos = torch.arange(slot, dtype=torch.int64, device=buf.device)
    idx = torch.clamp(starts.to(torch.int64)[..., None] + pos, 0, cap - 1)
    vals = torch.gather(buf.expand(lead + (cap,)), -1,
                        idx.reshape(lead + (k * slot,)))
    del idx
    valid = pos < counts[..., None]
    return torch.where(valid, vals.reshape(lead + (k, slot)),
                       hi_sentinel(buf.dtype))


def cap_to(merged: torch.Tensor, cap: int) -> torch.Tensor:
    """Slice/pad sorted rows (..., n) to a static capacity (sentinel-filled
    tail)."""
    n = merged.shape[-1]
    if n >= cap:
        return merged[..., :cap]
    return torch.cat([merged, torch.full(merged.shape[:-1] + (cap - n,),
                                         hi_sentinel(merged.dtype),
                                         dtype=merged.dtype,
                                         device=merged.device)], dim=-1)


#: Calls of `merge_ragged_runs` by the branch they took ("merge_tree" or
#: "full_sort"), for a run to read which one its merges went through.
ragged_branches: Counter = Counter()


def merge_ragged_runs(buf: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor, slot: int | None = None, *,
                      full_sort) -> torch.Tensor:
    """Sort each row of (..., cap) that holds k sorted runs at traced
    offsets (starts and counts (..., k); every other slot holds the hi
    sentinel): bit-identical to a full sort of the row (counterpart of
    the reference's merge_ragged_runs and merge_ragged_runs_batched,
    merge/ops.py:164-234; the leading axes are rows).

    `slot` is the merge tree's static per-run capacity, rounded up to a
    power of two (memory is k*slot a row); None is the whole row, which
    fits every run. A run past the slot (the splitting broke its eps
    guarantee) sends the call to `full_sort`, a full local sort of the
    buffers (`dispatch.merge_ragged` passes its policy's local sort). The
    reference picks the branch with a lax.cond on the device; here the
    branch is read on the host, once per call for all rows, as the
    splitter rounds' early exit is (core/splitters.py). Each call adds one
    to `ragged_branches` under the branch it took."""
    cap = buf.shape[-1]
    slot = pow2_ceil(cap if slot is None else min(slot, cap))
    if slot < cap:
        with sync_site("ragged.branch"):
            spill = bool((counts > slot).any())
        if spill:
            ragged_branches["full_sort"] += 1
            return full_sort(buf)
    ragged_branches["merge_tree"] += 1
    return merge_sorted_runs(gather_runs(buf, starts, counts, slot),
                             counts=counts, out_len=cap)


#: The reference's batched name; `merge_ragged_runs` already takes rows.
merge_ragged_runs_batched = merge_ragged_runs
