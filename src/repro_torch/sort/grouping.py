"""Length bucketing for the batched sort engine.

The port's own copy of `group_by_length` from `repro.sort.grouping`
(grouping.py:25-77), numpy-free plain Python, so that `repro_torch` needs
nothing of the JAX package. The rest of that module (the counting-sort
dispatch helpers of MoE routing) comes with ROADMAP queue 1 item 6.
"""
from __future__ import annotations


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
