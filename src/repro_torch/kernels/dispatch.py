"""Kernel-policy dispatch (counterpart of repro.kernels.dispatch).

One selection layer over the sort hot spots — `local_sort`, `probe_ranks`
and the post-exchange `merge_runs` and `merge_ragged` — so the CPU tests
and the card share one code path. The policy decides what runs:

  "auto"    (default) the CUDA kernels on a CUDA tensor of keys no wider
            than 4 bytes, the torch primitives on a CPU tensor and on
            64-bit keys (int64 packing, float64 and int64 keys), as the
            reference sends those to XLA: no Pallas kernel sorts 64-bit
            keys, so the kernels here take int32 only.
  "kernel"  always the kernel wrappers: on a CUDA tensor they launch the
            hand-written kernels; on a CPU tensor they run the kernels'
            plain PyTorch versions (the counterpart of Pallas interpret
            mode, repro/kernels/__init__.py:28). On 64-bit keys they raise
            TypeError; nothing gives way to the torch route.
  "torch"   always the torch primitives (`torch.sort`,
            `torch.searchsorted`), the counterpart of "xla".

Every policy returns the same bits for inputs within the key contract.
All inputs are rows: any leading axes (the emulated shards, or the batched
engine's (p, B)) are independent rows, so the reference's `*_batched`
entry points are the same functions here; under "torch" each is one
`torch.sort(dim=-1)` or one row-batched `torch.searchsorted`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort import ops as bops
from repro_torch.kernels.histogram import ops as hops
from repro_torch.kernels.histogram import ref as href
from repro_torch.kernels.merge import ops as mops
from repro_torch.runtime import trace

POLICIES = ("auto", "kernel", "torch")

# "auto" size ceiling for a full bitonic sort of one row: the network is
# O(n log^2 n) compares and pads to the next power of two, the right trade
# at shard scale but not for whole-array sorts (the p == 1 short-circuit).
# Past this, "auto" keeps torch.sort. An explicit "kernel" is honored.
AUTO_SORT_MAX_N = 1 << 22


def resolve_policy(policy: str, device, dtype: torch.dtype | None = None
                   ) -> str:
    """-> "kernel" | "torch" for keys of `dtype` on `device`."""
    if policy not in POLICIES:
        raise ValueError(
            f"unknown kernel_policy {policy!r}; available: {POLICIES}")
    if policy != "auto":
        return policy
    if dtype is not None and dtype.itemsize > 4:
        return "torch"
    return "kernel" if torch.device(device).type == "cuda" else "torch"


def local_sort_fn(policy: str = "auto"):
    """The policy bound into a rows -> sorted rows callable."""
    return lambda x: local_sort(x, policy=policy)


def local_sort(x: torch.Tensor, *, policy: str = "auto",
               block: int | None = None) -> torch.Tensor:
    """Sort each row of (..., n) (sentinel-padded rows welcome: sentinels
    are ordinary largest keys and land on the tail). AUTO_SORT_MAX_N
    applies to the row length."""
    if policy == "auto" and x.shape[-1] > AUTO_SORT_MAX_N:
        policy = "torch"
    if resolve_policy(policy, x.device, x.dtype) == "torch":
        return torch.sort(x, dim=-1).values
    return bops.local_sort(x, block=block or bops.DEFAULT_BLOCK)


def probe_ranks(keys: torch.Tensor, probes: torch.Tensor, *,
                policy: str = "auto",
                assume_sorted: bool = False) -> torch.Tensor:
    """rank[..., m] = #{keys[...] < probes[..., m]} as int32: keys (..., n),
    probes (..., M) whose leading axes broadcast against the keys' (a
    request's probe row serves all its shards; (M,) serves every row) ->
    (..., M).

    `assume_sorted` says each row of keys is sorted ascending, as every
    splitter pipeline's locally sorted shards are. The kernel route then
    searches (K4s) and the torch route runs `searchsorted`; otherwise the
    kernel route counts (K4, any key order) and the torch route sorts and
    searches.
    """
    probes = probes.expand(keys.shape[:-1] + probes.shape[-1:])
    if probes.shape[-1] == 0:
        return torch.zeros(probes.shape, dtype=torch.int32,
                           device=keys.device)
    if resolve_policy(policy, keys.device, keys.dtype) == "torch":
        if assume_sorted:
            return torch.searchsorted(keys.contiguous(), probes.contiguous(),
                                      side="left").to(torch.int32)
        return href.probe_ranks_ref(keys, probes)
    return hops.probe_ranks(keys, probes, assume_sorted=assume_sorted)


def merge_runs(runs: torch.Tensor, *, policy: str = "auto") -> torch.Tensor:
    """Merge the k sorted runs of each row of (..., k, r) -> (..., k*r).

    Bit-identical to `torch.sort` of each row; the kernel path merges in
    log(k) passes instead of re-sorting."""
    with trace.span("merge"):
        if resolve_policy(policy, runs.device, runs.dtype) == "torch":
            return torch.sort(runs.reshape(runs.shape[:-2] + (-1,)),
                              dim=-1).values
        return mops.merge_sorted_runs(runs)


def merge_ragged(buf: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, *, policy: str = "auto",
                 slot: int | None = None) -> torch.Tensor:
    """Sort each row of (..., cap) holding sorted runs at traced offsets
    (starts, counts (..., k)), the hi sentinel elsewhere. Bit-identical to
    `torch.sort` of each row; see kernels.merge.ops.merge_ragged_runs for
    the slot and its full-sort branch."""
    with trace.span("merge"):
        if resolve_policy(policy, buf.device, buf.dtype) == "torch":
            return torch.sort(buf, dim=-1).values
        return mops.merge_ragged_runs(buf, starts, counts, slot=slot)


# The reference's batched names (dispatch.py:67-179): the same functions.
local_sort_batched_fn = local_sort_fn
local_sort_batched = local_sort
probe_ranks_batched = probe_ranks
merge_runs_batched = merge_runs
merge_ragged_batched = merge_ragged
