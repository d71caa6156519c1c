"""The plain reference of two-stage HSS (paper Sections 5.3 and 6.1): what
a sort over p = r1 * r2 shards in the node-level two-stage form owes its
caller, checked on the answer alone. It imports nothing of the port: it
is given the keys a call sorted and the answer's shard rows and counts,
shard s = outer * r2 + inner (group `outer`, its `inner`-th shard).

Stage 1 splits the N keys into r1 groups, stage 2 each group's G keys
into its r2 shards, each with HSS's tolerance: a part of n keys over
`parts` parts holds at most (1 + eps) n / parts. So

  the answer      equals torch's sort of the keys;
  a group         holds at most (1 + eps) N / r1 keys;
  a shard         holds at most (1 + eps) G / r2 of its group's G;
  a shard         holds at most (1 + eps)^2 N / p, the configuration's
                  `balance_eps` of (1 + eps)^2 - 1.

Loads are whole keys: each limit rounds the even share and the two
splitter tolerances around a part up to whole keys (`part_limit`), which
adds at most three keys to it. Each number comes back beside its limit,
as `hssbench/reference.py` gives them.
"""
from __future__ import annotations

import math

import torch

from hssbench.reference import valid_keys, wrong_keys


def part_limit(n: float, parts: int, eps: float) -> int:
    """The most keys a part of n keys split over `parts` parts may hold:
    its share n / parts and a tolerance of eps * n / (2 * parts) at each of
    its two splitters, each rounded up to whole keys."""
    return math.ceil(n / parts) + 2 * math.ceil(eps * n / (2 * parts))


def _excess(load: float, share: float) -> float:
    return load / share - 1.0


def stage_checks(keys: torch.Tensor, shards: torch.Tensor, counts,
                 r1: int, r2: int, eps: float) -> dict:
    """keys: the call's input (N,); shards (p, cap) and counts (p,): its
    answer, each row's valid prefix in shard order -> {name: {"value",
    "limit", "ok"}}: `wrong_keys` (the answer against the sorted keys),
    `group_excess` (max group load over N / r1, less 1),
    `shard_excess_in_group` (a group's fullest shard over G / r2, less 1,
    for the group nearest its limit) and `shard_excess` (max shard load
    over N / p, less 1)."""
    p, n = r1 * r2, int(keys.numel())
    counts = torch.as_tensor(counts).to("cpu", torch.int64).reshape(-1)
    if counts.numel() != p:
        raise ValueError(f"{counts.numel()} shard counts for a ({r1}, {r2}) "
                         f"grid")
    wrong = wrong_keys(valid_keys(shards, counts).to(keys.device),
                       torch.sort(keys.reshape(-1)).values)
    counts = counts.reshape(r1, r2)
    groups = counts.sum(dim=1)                                  # (r1,)
    group_cap = part_limit(n, r1, eps)
    # each group's fullest shard against its own group's limit; the group
    # nearest its limit (or farthest past it) is the one reported
    in_group = max(((_excess(max(row), g / r2),
                     _excess(part_limit(g, r2, eps), g / r2))
                    for row, g in zip(counts.tolist(), groups.tolist())
                    if g > 0), key=lambda e: e[0] - e[1])
    total_cap = part_limit(group_cap, r2, eps)
    out = {
        "wrong_keys": (wrong, 0),
        "group_excess": (_excess(int(groups.max()), n / r1),
                         _excess(group_cap, n / r1)),
        "shard_excess_in_group": in_group,
        "shard_excess": (_excess(int(counts.max()), n / p),
                         _excess(total_cap, n / p)),
    }
    return {k: {"value": v, "limit": lim, "ok": v <= lim}
            for k, (v, lim) in out.items()}
