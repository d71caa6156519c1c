"""Kernel-policy dispatch (counterpart of repro.kernels.dispatch).

One selection layer over the sort hot spots — `local_sort`, `probe_ranks`
and the post-exchange `merge_runs` — so the CPU tests and the card share
one code path. The policy decides what runs:

  "auto"    (default) the CUDA kernels on a CUDA tensor, the torch
            primitives on a CPU one.
  "kernel"  always the kernel wrappers: on a CUDA tensor they launch the
            hand-written kernels; on a CPU tensor they run the kernels'
            plain PyTorch versions (the counterpart of Pallas interpret
            mode, repro/kernels/__init__.py:28).
  "torch"   always the torch primitives (`torch.sort`,
            `torch.searchsorted`), the counterpart of "xla".

Every policy returns the same bits for inputs within the key contract.
All inputs are rows: the leading axis is the emulated shard (or any other
batch of independent rows).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort import ops as bops
from repro_torch.kernels.histogram import ops as hops
from repro_torch.kernels.histogram import ref as href
from repro_torch.kernels.merge import ops as mops

POLICIES = ("auto", "kernel", "torch")

# "auto" size ceiling for a full bitonic sort of one row: the network is
# O(n log^2 n) compares and pads to the next power of two, the right trade
# at shard scale but not for whole-array sorts (the p == 1 short-circuit).
# Past this, "auto" keeps torch.sort. An explicit "kernel" is honored.
AUTO_SORT_MAX_N = 1 << 22


def resolve_policy(policy: str, device) -> str:
    """-> "kernel" | "torch" for a tensor on `device`."""
    if policy not in POLICIES:
        raise ValueError(
            f"unknown kernel_policy {policy!r}; available: {POLICIES}")
    if policy != "auto":
        return policy
    return "kernel" if torch.device(device).type == "cuda" else "torch"


def local_sort_fn(policy: str = "auto"):
    """The policy bound into a rows -> sorted rows callable."""
    return lambda x: local_sort(x, policy=policy)


def local_sort(x: torch.Tensor, *, policy: str = "auto",
               block: int | None = None) -> torch.Tensor:
    """Sort each row of (rows, n) (sentinel-padded rows welcome: sentinels
    are ordinary largest keys and land on the tail)."""
    if policy == "auto" and x.shape[-1] > AUTO_SORT_MAX_N:
        policy = "torch"
    if resolve_policy(policy, x.device) == "torch":
        return torch.sort(x, dim=-1).values
    return bops.local_sort(x, block=block or bops.DEFAULT_BLOCK)


def probe_ranks(keys: torch.Tensor, probes: torch.Tensor, *,
                policy: str = "auto",
                assume_sorted: bool = False) -> torch.Tensor:
    """rank[r, m] = #{keys[r] < probes[m]} as int32: keys (rows, n), probes
    (M,) shared by all rows or (rows, M) -> (rows, M).

    The kernel counts rather than searches, so it needs no sorted keys.
    The torch path uses `searchsorted` when `assume_sorted` (every splitter
    pipeline ranks over locally sorted shards) and sort + search otherwise.
    """
    rows = keys.shape[0]
    if probes.shape[-1] == 0:
        return torch.zeros((rows, 0), dtype=torch.int32, device=keys.device)
    if resolve_policy(policy, keys.device) == "torch":
        rows_probes = probes.expand(rows, -1).contiguous()
        if assume_sorted:
            return torch.searchsorted(keys.contiguous(), rows_probes,
                                      side="left").to(torch.int32)
        return href.probe_ranks_ref(keys, rows_probes)
    return hops.probe_ranks(keys, probes)


def merge_runs(runs: torch.Tensor, *, policy: str = "auto") -> torch.Tensor:
    """Merge the k sorted runs of each row of (rows, k, r) -> (rows, k*r).

    Bit-identical to `torch.sort(runs.reshape(rows, -1))`; the kernel path
    merges in log(k) passes instead of re-sorting."""
    if resolve_policy(policy, runs.device) == "torch":
        return torch.sort(runs.reshape(runs.shape[0], -1), dim=-1).values
    return mops.merge_sorted_runs(runs)
