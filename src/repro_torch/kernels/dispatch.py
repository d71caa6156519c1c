"""Kernel-policy dispatch (counterpart of repro.kernels.dispatch).

One selection layer over the sort hot spots — `local_sort`, `probe_ranks`,
the splitter rounds' `sample_compact` and the post-exchange `merge_runs`
and `merge_ragged` — so the CPU tests and the card share one code path.
The policy decides what runs:

  "auto"    (default) the CUDA kernels on a CUDA tensor, the torch
            primitives on a CPU tensor. The core's 64-bit keys (int64 tag
            packing, int64 and float64 user keys) are searched (K4s),
            sampled (K6) and merged (K5) by the kernels' int64
            instantiations, and sorted locally by `torch.sort`: the
            bitonic kernels K1-K3 (and the counting K4) take int32 only,
            as no Pallas kernel of the reference takes 64-bit keys.
  "kernel"  always the kernel wrappers: on a CUDA tensor they launch the
            hand-written kernels; on a CPU tensor they run the kernels'
            plain PyTorch versions (the counterpart of Pallas interpret
            mode, repro/kernels/__init__.py:28). 64-bit probes, samples
            and merges run K4s, K6 and K5; a 64-bit local sort (or count)
            raises TypeError: nothing gives way to the torch route.
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

from repro_torch.core.common import hi_sentinel
from repro_torch.kernels.bitonic_sort import ops as bops
from repro_torch.kernels.histogram import ops as hops
from repro_torch.kernels.histogram import ref as href
from repro_torch.kernels.merge import ops as mops
from repro_torch.kernels.sample import kernel as skernel
from repro_torch.runtime import trace

POLICIES = ("auto", "kernel", "torch")

# "auto" size ceiling for a full bitonic sort of one row: the network is
# O(n log^2 n) compares and pads to the next power of two, the right trade
# at shard scale but not for whole-array sorts (the p == 1 short-circuit).
# Past this, "auto" keeps torch.sort. An explicit "kernel" is honored.
AUTO_SORT_MAX_N = 1 << 22


def resolve_policy(policy: str, device, dtype: torch.dtype | None = None,
                   *, wide: bool = False) -> str:
    """-> "kernel" | "torch" for keys of `dtype` on `device`; `wide` says
    the kernels of the hot spot take 64-bit keys too (K4s, K5)."""
    if policy not in POLICIES:
        raise ValueError(
            f"unknown kernel_policy {policy!r}; available: {POLICIES}")
    if policy != "auto":
        return policy
    if dtype is not None and dtype.itemsize > 4 and not wide:
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
    if resolve_policy(policy, keys.device, keys.dtype,
                      wide=assume_sorted) == "torch":
        if assume_sorted:
            return torch.searchsorted(keys.contiguous(), probes.contiguous(),
                                      side="left").to(torch.int32)
        return href.probe_ranks_ref(keys, probes)
    return hops.probe_ranks(keys, probes, assume_sorted=assume_sorted)


def gamma_mask(x: torch.Tensor, lo_key: torch.Tensor, hi_key: torch.Tensor,
               satisfied: torch.Tensor) -> torch.Tensor:
    """Which keys of x (..., n) lie in an active splitter interval,
    lo_key_i < x < hi_key_i for some unsatisfied i, as the reference tests
    each key (splitters.py:134): the containing intervals form a run [a,
    b) over i, so two searchsorteds and a prefix-sum lookup. The state
    (..., m) broadcasts against x's leading axes, right-aligned."""
    lead = x.shape[:-1]
    m = hi_key.shape[-1]
    unsat = (~satisfied).to(torch.int32)
    csum = torch.cat([torch.zeros(unsat.shape[:-1] + (1,), dtype=torch.int32,
                                  device=x.device),
                      torch.cumsum(unsat, -1, dtype=torch.int32)], dim=-1)
    csum = csum.expand(lead + (m + 1,))
    hi_key = hi_key.expand(lead + (m,)).contiguous()
    lo_key = lo_key.expand(lead + (m,)).contiguous()
    a = torch.searchsorted(hi_key, x, side="right")
    b = torch.searchsorted(lo_key, x, side="left")
    b = torch.maximum(a, b)
    return (torch.gather(csum, -1, b) - torch.gather(csum, -1, a)) > 0


def sample_compact(keys: torch.Tensor, lo_key: torch.Tensor,
                   hi_key: torch.Tensor, satisfied: torch.Tensor,
                   u: torch.Tensor, prob: torch.Tensor, cap: int, *,
                   policy: str = "auto"):
    """One splitter round's Bernoulli sample of sorted rows: keys (S, B, n),
    row (s, b) sorted ascending; the state (B, m), or anything that
    broadcasts to it; draws u (S, n) shared by the B requests or (S, B, n);
    prob (B,) -> (vals (S, B, min(cap, n)) the first kept keys in order,
    then the hi sentinel; sampled (S, B); overflow (S, B)). The kernel
    route compacts (K6, `kernels.sample.kernel`); the torch route is the
    reference's: `gamma_mask`, the mask, and `torch.sort` of every masked
    row. Both give the same bits for any state whose keys are
    nondecreasing in i, as refine keeps them."""
    if resolve_policy(policy, keys.device, keys.dtype, wide=True) == "torch":
        if u.dim() == 2:
            u = u[:, None, :]
        mask = (gamma_mask(keys, lo_key, hi_key, satisfied)
                & (u < prob[:, None]))
        n_hit = mask.sum(dim=-1, dtype=torch.int32)
        vals = torch.where(mask, keys, hi_sentinel(keys.dtype))
        vals = torch.sort(vals, dim=-1).values[..., :cap]
        overflow = torch.clamp(n_hit - cap, min=0)
        return vals, n_hit - overflow, overflow
    batch, m = keys.shape[1], lo_key.shape[-1]
    state = (t.expand(batch, m).contiguous()
             for t in (lo_key, hi_key, satisfied))
    return skernel.sample_compact(keys.contiguous(), *state, u.contiguous(),
                                  prob.expand(batch).contiguous(), cap)


def merge_runs(runs: torch.Tensor, *, policy: str = "auto",
               counts: torch.Tensor | None = None,
               out_len: int | None = None) -> torch.Tensor:
    """Merge the k sorted runs of each row of (..., k, r) -> (..., out_len)
    (default k*r). `counts` (..., k), where given, says that each run's
    slots past its count hold the hi sentinel.

    Bit-identical to `cap_to(torch.sort(row), out_len)` of each row; the
    kernel path merges only the runs' valid prefixes, in ceil(log2 k) K5
    levels, instead of re-sorting (kernels.merge.ops.merge_sorted_runs)."""
    with trace.span("merge"):
        if resolve_policy(policy, runs.device, runs.dtype,
                          wide=True) == "torch":
            merged = torch.sort(runs.reshape(runs.shape[:-2] + (-1,)),
                                dim=-1).values
            return merged if out_len is None else mops.cap_to(merged,
                                                              out_len)
        return mops.merge_sorted_runs(runs, counts=counts, out_len=out_len)


def merge_ragged(buf: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, *, policy: str = "auto",
                 slot: int | None = None) -> torch.Tensor:
    """Sort each row of (..., cap) holding sorted runs at traced offsets
    (starts, counts (..., k)), the hi sentinel elsewhere. Bit-identical to
    `torch.sort` of each row; see kernels.merge.ops.merge_ragged_runs for
    the slot and its full-sort branch: the bitonic kernels, or
    `torch.sort` where the policy sends the rows' dtype there (64-bit
    rows under "auto")."""
    def full_sort(rows):
        if resolve_policy(policy, rows.device, rows.dtype) == "torch":
            return torch.sort(rows, dim=-1).values
        return bops.local_sort(rows)

    with trace.span("merge"):
        if resolve_policy(policy, buf.device, buf.dtype,
                          wide=True) == "torch":
            return torch.sort(buf, dim=-1).values
        return mops.merge_ragged_runs(buf, starts, counts, slot=slot,
                                      full_sort=full_sort)


# The reference's batched names (dispatch.py:67-179): the same functions.
local_sort_batched_fn = local_sort_fn
local_sort_batched = local_sort
probe_ranks_batched = probe_ranks
merge_runs_batched = merge_runs
merge_ragged_batched = merge_ragged
