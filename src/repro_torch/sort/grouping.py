"""Length bucketing and device-level grouping (counterpart of
repro.sort.grouping; DESIGN.md Sec. 4.1 and 10).

`group_by_length` is the batched sort engine's bucketing policy. The rest
is MoE token dispatch, the paper's partitioning problem at micro scale: N
items carrying small destination ids are placed into per-destination
capacity bins. `grouping_permutation` is a stable counting sort, the
device-level semisort where every id of the tiny [0, n_groups) domain is
a known heavy hitter, so no comparison sort runs; `counting_dispatch`
gives the permutation and the bin slots, by that counting sort
(`method="counting"`, the default) or by a stable argsort
(`method="argsort"`), with the same bits for MoE-shaped ids. These are
torch ops of one device; the reference's are jnp ops with no Pallas
kernel, so no kernel of the port runs here.
"""
from __future__ import annotations

import torch

# The default `counting_dispatch` method (grouping.py:22).
DEFAULT_DISPATCH_METHOD = "counting"


def group_by_length(seqs, *, multiple: int = 1, max_groups: int = 0) -> dict:
    """Group request indices by key-array length.

    The batched sort engine's bucketing policy: requests of equal length
    stack into one (B, n) batch and share one pipeline
    (repro_torch.sort.sort_batched). Returns {length: [request indices]};
    with the defaults the lengths are exact and the dict is in first-seen
    order.

    `multiple` > 1 quantizes each length up to the next multiple before
    grouping; `max_groups` > 0 coalesces to at most that many groups by
    merging runs of *adjacent* lengths, balanced by request count, keyed
    by the run's max length. Both knobs return ascending-length keys with
    ascending request indices.

    An empty request list returns {}; all-equal lengths collapse to one
    group whatever `max_groups` says; `max_groups` above the number of
    distinct (quantized) lengths returns one group per length — never
    empty groups, never a split of an equal-length run.
    """
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    groups: dict = {}
    for i, s in enumerate(seqs):
        n = int(s.shape[0]) if hasattr(s, "shape") else int(len(s))
        if multiple > 1:
            n = -(-n // multiple) * multiple
        groups.setdefault(n, []).append(i)
    if max_groups <= 0 or max_groups >= len(groups):
        if multiple > 1:
            return {n: groups[n] for n in sorted(groups)}
        return groups
    # coalesce ascending lengths into max_groups contiguous runs with
    # near-equal request counts (greedy ceil(left/slots) targets; each run
    # keeps at least one length and leaves one per remaining slot)
    lens = sorted(groups)
    out: dict = {}
    i, left = 0, sum(len(v) for v in groups.values())
    for slots in range(max_groups, 0, -1):
        target = -(-left // slots)
        run, count = [], 0
        while i < len(lens) and (not run or
                                 (count < target
                                  and len(lens) - i > slots - 1)):
            run.append(lens[i])
            count += len(groups[lens[i]])
            i += 1
        out[run[-1]] = sorted(j for n in run for j in groups[n])
        left -= count
    return out


def group_slots(sorted_group_ids: torch.Tensor, n_groups: int,
                capacity: int):
    """Positions of already sorted group ids within per-group capacity
    bins -> (slot, keep), int32 and bool: slot in [0, n_groups*capacity)
    for kept entries; an id out of range or past its group's capacity gets
    slot n_groups*capacity (the buffer's overflow row) and keep False."""
    ids = sorted_group_ids
    n = ids.shape[0]
    dev = ids.device
    starts = torch.searchsorted(
        ids, torch.arange(n_groups, dtype=ids.dtype, device=dev),
        side="left").to(torch.int32)
    cls = torch.clamp(ids, 0, n_groups - 1).to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=dev) - starts[cls]
    valid = (ids >= 0) & (ids < n_groups)
    keep = valid & (pos < capacity)
    slot = cls * capacity + torch.clamp(pos, 0, capacity - 1)
    return torch.where(keep, slot, n_groups * capacity), keep


def _class_ranks(group_ids: torch.Tensor, n_groups: int):
    """Stable counting-sort bookkeeping over the classes {-1} + [0,
    n_groups), ids out of range in class -1 -> (cls, rank, pos), int32,
    along the last axis (each leading index is a row of its own): each
    item's class, its 0-based stable rank in the class and its position
    in the grouped (class-major, input order within a class) permutation.
    The one-hot cumsum is (..., n, n_groups+1) int32; the rank is read off
    it at each item's class (the reference sums the masked row, the same
    value)."""
    dev = group_ids.device
    valid = (group_ids >= 0) & (group_ids < n_groups)
    cls = torch.where(valid, group_ids, -1).to(torch.int32)
    onehot = cls[..., None] == torch.arange(-1, n_groups, dtype=torch.int32,
                                            device=dev)
    sizes = onehot.sum(dim=-2, dtype=torch.int32)
    counts = onehot.to(torch.int32)
    del onehot
    counts.cumsum_(dim=-2)         # in place: one (..., n, n_groups+1) buffer
    col = (cls + 1).to(torch.int64)
    rank = torch.gather(counts, -1, col[..., None])[..., 0] - 1
    del counts
    starts = torch.cumsum(sizes, dim=-1, dtype=torch.int32) - sizes
    pos = torch.gather(starts, -1, col) + rank
    return cls, rank, pos


def _scatter_order(pos: torch.Tensor) -> torch.Tensor:
    """order[..., pos[..., i]] = i, int32."""
    n = pos.shape[-1]
    order = torch.zeros(pos.shape, dtype=torch.int32, device=pos.device)
    order.scatter_(-1, pos.to(torch.int64),
                   torch.arange(n, dtype=torch.int32,
                                device=pos.device).expand(pos.shape))
    return order


def grouping_permutation(group_ids: torch.Tensor,
                         n_groups: int) -> torch.Tensor:
    """The stable grouping permutation by counting sort (int32): ids out
    of range group at the front in input order. Equal to a stable argsort
    of the ids whenever those are all one negative value (MoE dispatch,
    where the only invalid id is -1)."""
    _, _, pos = _class_ranks(group_ids, n_groups)
    return _scatter_order(pos)


def counting_dispatch(group_ids: torch.Tensor, n_groups: int, capacity: int,
                      method: str | None = None):
    """Stable dispatch of items into per-group capacity bins -> (order,
    slot, keep): `order` the stable grouping permutation (int32; ties keep
    input order), slot and keep indexed by grouped position, as
    `group_slots` of the ordered ids gives them. Under "counting" the ids
    may carry leading axes, each row dispatched on its own. Scatter
    pattern:

        buf = zeros((n_groups*capacity + 1, d)); buf[slot] = rows[order]

    method "counting" (the default, DEFAULT_DISPATCH_METHOD) runs the
    O(n * n_groups) counting sort; "argsort" a stable argsort and
    `group_slots`. Both give the same bits for MoE-shaped ids (every
    invalid id -1); for mixed invalid ids only the order among the invalid
    entries may differ, and `keep` drops those either way."""
    method = method or DEFAULT_DISPATCH_METHOD
    if method == "argsort":
        order = torch.argsort(group_ids, stable=True).to(torch.int32)
        slot, keep = group_slots(group_ids[order.to(torch.int64)], n_groups,
                                 capacity)
        return order, slot, keep
    if method != "counting":
        raise ValueError(f"unknown dispatch method {method!r}")
    cls, rank, pos = _class_ranks(group_ids, n_groups)
    order = _scatter_order(pos)
    # slot and keep per input item (the counting path never needs the ids
    # sorted), then carried to the grouped positions by `order`
    keep_i = (cls >= 0) & (rank < capacity)
    slot_i = torch.where(
        keep_i,
        torch.clamp(cls, 0, n_groups - 1) * capacity
        + torch.clamp(rank, 0, capacity - 1),
        n_groups * capacity)
    o = order.to(torch.int64)
    return order, torch.gather(slot_i, -1, o), torch.gather(keep_i, -1, o)
