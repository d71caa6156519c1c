"""The sort front door: `sort`, `sort_batched`, `argsort`, `sort_kv` and
`gather` (counterpart of repro.sort.api).

    from repro_torch.sort import SortSpec, argsort, sort, sort_batched
    out = sort(x)                                 # HSS, 8 shards, on the card
    out = sort(x, SortSpec(shards=4, device="cpu"))
    out = sort(x, algorithm="ams")                # or sample_random,
                                                  # sample_regular, multistage
    out = sort(x, exchange="ragged")              # the exact alltoallv
    out = sort(x, kernel_policy="torch")          # kwargs override the spec
    out.gather()                                  # flat sorted NumPy array
    out = sort(x, on_overflow="retry")            # exact; see out.recovery

    outs = sort_batched(xs)                       # xs (B, n): one pipeline
    outs.gather(b)                                # request b, sorted
    views = sort_batched([x0, x1, x2])            # any lengths: one batch
                                                  # per length, input order
    outs = sort(xs, SortSpec(batch=True))         # the same as sort_batched

    order = argsort(x)                            # stable, NumPy (n,)
    keys, vals = sort_kv(expert_ids, token_ids)   # from repro_torch.sort

`x` is a 1-D int32, uint32, float32, int64 or float64 NumPy array or
tensor. The overflow policy (`SortSpec.on_overflow`) runs around every
launch: under "raise" `out.overflow` is returned on the device, uncounted
on the host, and 0 means the result is exact (as at repro/sort/api.py:294);
"retry" reads it on the host once per launch and escalates; "spill" swaps
in the exact dense_spill exchange. `argsort` and `sort_kv` raise when the
gathered permutation is short, whatever the policy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.sort import driver
from repro_torch.sort.adapters import (
    BatchedSortOutput, SortOutput, as_keys, make_plan)
from repro_torch.sort.grouping import group_by_length
from repro_torch.sort.partitioners import ShardCtx, get_partitioner
from repro_torch.sort.spec import SortSpec


@dataclasses.dataclass(frozen=True)
class RecoveryStats:
    """How the recovery policies resolved a sort (`out.recovery`; None when
    no policy recorded anything). Field for field the reference's
    (repro/sort/api.py:38-73); the port runs the overflow policy, so the
    verify and imbalance fields keep their defaults (ROADMAP queue 1
    item 5).

    policy            the on_overflow policy that ran.
    attempts          launches in all; 1 = the first was already exact.
    escalations       capacity_scale of each re-launch, in order.
    spill_fallback    True when the last attempt ran on the spill channel.
    recovered_overflow  the first (failed) launch's overflow count.
    verify_failures, verify_retries, verify_fallback, achieved_imbalance,
    imbalance_recovery  the verification and imbalance policies' record.
    """

    policy: str
    attempts: int
    escalations: tuple
    spill_fallback: bool
    recovered_overflow: int
    verify_failures: int = 0
    verify_retries: int = 0
    verify_fallback: bool = False
    achieved_imbalance: float | None = None
    imbalance_recovery: str | None = None


def _as_spec(spec, overrides) -> SortSpec:
    if spec is None:
        return SortSpec(**overrides)
    if not isinstance(spec, SortSpec):
        raise TypeError(f"spec must be a SortSpec, got {type(spec)}")
    return dataclasses.replace(spec, **overrides) if overrides else spec


def resolve_device(device) -> torch.device:
    """The spec's device; a CUDA device with no card raises (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SortSpec(device='cuda') but no CUDA device is available; pass "
            "device='cpu' to run the port's plain versions on the CPU")
    return dev


def sort(x, spec: SortSpec | None = None, *, uniform=None,
         **overrides) -> SortOutput:
    """Sort a 1-D key array over `spec.shards` emulated shards, under the
    spec's overflow policy. With `SortSpec(batch=True)` the input goes to
    `sort_batched` instead.

    `uniform` (optional) injects the sampling draws: (j, n) -> (p, n)
    float32 U[0, 1) array, draw j of n keys a shard, row s for shard s, in
    place of the seeded generator (the parity tests feed the reference's
    draws; `repro_torch.sort.partitioners` says how each algorithm
    numbers its draws). Every attempt of the retry policy takes the same
    draws, as every attempt of the reference's reseeds from
    `spec.seed`."""
    spec = _as_spec(spec, overrides)
    if spec.batch:
        return sort_batched(x, spec, uniform=uniform)
    x = as_keys(x, resolve_device(spec.device))
    return _with_overflow_policy(
        lambda s: _sort_one(x, s, uniform, want_indices=False), spec)


def _sort_one(x, spec: SortSpec, uniform, want_indices: bool) -> SortOutput:
    """One launch of one request, x a tensor on the spec's device: the
    batched engine at B = 1, the batch axis squeezed out."""
    if x.dim() != 1:
        raise ValueError(f"sort expects a 1-D key array, got {tuple(x.shape)}")
    if spec.initial_probes is not None:
        spec = dataclasses.replace(
            spec, initial_probes=as_keys(spec.initial_probes, x.device)[None])
    out = _sort_batched_impl(x[None], spec, uniform, want_indices).request(0)
    if out.stats is not None:
        out.stats = type(out.stats)(*(f[..., 0] for f in out.stats))
    return out


def sort_batched(xs, spec: SortSpec | None = None, *, uniform=None,
                 **overrides):
    """Sort B independent key arrays in one pipeline, under the spec's
    overflow policy (one policy for the batch: "retry" re-runs the whole
    batch while any request overflows).

    xs: a (B, n) array of B equal-length requests — returns a
    BatchedSortOutput — or a list or tuple of 1-D arrays of any lengths,
    which is bucketed by length (`group_by_length`; one batch per distinct
    length, each under the policy) and returns a list of per-request
    SortOutput views in input order. Per request the result is
    bit-identical to `sort()` of that request with the same spec and seed
    when both plans agree (fix `tag`); each collective of the batch-fused
    exchanges is one call per phase whatever B is. `uniform` is as in
    `sort`: every request shares the shards' draws.
    """
    spec = _as_spec(spec, overrides)
    if isinstance(xs, (list, tuple)):
        return _sort_batched_buckets(xs, spec, uniform)
    xs = as_keys(xs, resolve_device(spec.device))
    return _with_overflow_policy(
        lambda s: _sort_batched_impl(xs, s, uniform), spec)


def _sort_batched_impl(xs, spec: SortSpec, uniform,
                       want_indices: bool = False) -> BatchedSortOutput:
    part = get_partitioner(spec.algorithm)
    dev = resolve_device(spec.device)
    xs = as_keys(xs, dev)
    if xs.dim() != 2:
        raise ValueError(
            f"sort_batched expects a (B, n) key array, got {tuple(xs.shape)}")
    p = spec.shards

    plan = make_plan(xs, spec, p, want_indices=want_indices)
    enc = plan.encode(xs)
    probes = (plan.encode_probes(spec.initial_probes)
              if spec.initial_probes is not None else None)

    def sort_fn(rows, comm, draws):
        ctx = ShardCtx(spec=spec, comm=comm, uniform=draws,
                       initial_probes=probes)
        return part.sharded_batched(rows, ctx)

    raw = driver.run_batched(
        sort_fn, enc, p=p, seed=spec.seed, n_real=plan.n,
        local_sort_fn=dispatch.local_sort_fn(spec.kernel_policy),
        uniform=uniform)
    return plan.decode_batched(raw)


def _sort_batched_buckets(arrs, spec: SortSpec, uniform) -> list:
    """List input: one batch per distinct length, results back in input
    order as SortOutput views."""
    dev = resolve_device(spec.device)
    arrs = [as_keys(a, dev) for a in arrs]
    for a in arrs:
        if a.dim() != 1:
            raise ValueError(f"sort_batched list entries must be 1-D, got "
                             f"{tuple(a.shape)}")
    results = [None] * len(arrs)
    for idxs in group_by_length(arrs).values():
        stacked = torch.stack([arrs[i] for i in idxs])
        out = _with_overflow_policy(
            lambda s, xs=stacked: _sort_batched_impl(xs, s, uniform), spec)
        for j, i in enumerate(idxs):
            results[i] = out.request(j)
    return results


def _host_overflow(out) -> int:
    """The overflow counter on the host: the retry policy's one deliberate
    host sync per launch (the max over the batch on the batched path)."""
    return int(out.overflow.max())


def _warm_started(spec: SortSpec, out) -> SortSpec:
    """A failed attempt's splitter keys as warm-start probes, so the retry
    ranks p-1 known-good keys before it samples (the ChaNGa trick,
    pointed at recovery). HSS only: it is the one partitioner that takes
    probes (repro/sort/api.py:273)."""
    if spec.algorithm != "hss":
        return spec
    sk = out.splitter_keys
    if sk is None or sk.numel() == 0:
        return spec
    return dataclasses.replace(spec, initial_probes=sk)


def _with_overflow_policy(run, spec: SortSpec):
    """`run(spec)` under the spec's overflow policy (counterpart of
    repro/sort/api.py:261-304).

    "raise" and "spill" read no counter here: spill swapped the exchange
    for the exact channel in `spec.exchange_config()`, and raise leaves
    the check to the caller (`argsort`/`sort_kv` check the gathered
    length). "retry" reads the counter once per launch and, while it is
    nonzero, runs again with `capacity_scale` doubled and the failed
    attempt's splitters as warm start; the last attempt runs on the spill
    channel, and a RuntimeError follows only if even that truncates."""
    out = run(spec)
    if spec.on_overflow != "retry":
        return out
    ovf0 = _host_overflow(out)
    if ovf0 == 0:
        out.recovery = RecoveryStats("retry", 1, (), False, 0)
        return out
    esc = []
    for k in range(1, spec.max_overflow_retries + 1):
        scale = spec.capacity_scale * (2.0 ** k)
        esc.append(scale)
        out = run(dataclasses.replace(_warm_started(spec, out),
                                      capacity_scale=scale))
        if _host_overflow(out) == 0:
            out.recovery = RecoveryStats("retry", 1 + len(esc), tuple(esc),
                                         False, ovf0)
            return out
    out = run(dataclasses.replace(
        _warm_started(spec, out), on_overflow="spill",
        capacity_scale=esc[-1] if esc else spec.capacity_scale))
    left = _host_overflow(out)
    out.recovery = RecoveryStats("retry", 2 + len(esc), tuple(esc), True,
                                 ovf0)
    if left != 0:
        raise RuntimeError(
            f"sort overflow unrecovered after {len(esc)} capacity "
            f"escalations and a spill-channel attempt ({left} keys "
            "truncated at out_cap): the splitting violated its eps "
            "guarantee; raise out_slack or eps")
    return out


def gather_perm_checked(out: SortOutput, what: str) -> np.ndarray:
    """The permutation of a tagged sort, checked for exactness: dropped
    keys are exactly the keys missing from the gather, so the gathered
    length is checked, not the overflow counter (which also counts
    harmless sample-buffer overflow and dropped pads)."""
    order = out.gather_indices()
    if order.shape[0] != out.n:
        raise RuntimeError(
            f"{what}: exchange dropped {out.n - order.shape[0]} keys "
            "(capacity overflow): the result would not be a permutation. "
            "Use on_overflow='retry'/'spill', raise pair_factor/out_slack, "
            "or use exchange='allgather'.")
    return order


def argsort(x, spec: SortSpec | None = None, *, uniform=None,
            **overrides) -> np.ndarray:
    """Stable argsort: the permutation that sorts x, as a flat (n,) NumPy
    array. The tag of each key is its index, so the permutation comes out
    of the sorted keys. Raises if the exchange dropped keys;
    on_overflow="retry"/"spill" recover instead. `uniform` is as in
    `sort`."""
    spec = dataclasses.replace(_as_spec(spec, overrides), stable=True)
    x = as_keys(x, resolve_device(spec.device))
    out = _with_overflow_policy(
        lambda s: _sort_one(x, s, uniform, want_indices=True), spec)
    return gather_perm_checked(out, "argsort")


def sort_kv(keys, values, spec: SortSpec | None = None, *, uniform=None,
            **overrides):
    """Sort (key, value) pairs by key, stably -> NumPy (sorted_keys,
    sorted_values). Values may be multi-dimensional: the permutation
    applies along their leading axis, which must match the keys."""
    values = np.asarray(values)
    if values.shape[:1] != tuple(np.shape(keys)):
        raise ValueError(f"values leading dim {values.shape[:1]} != "
                         f"keys shape {tuple(np.shape(keys))}")
    spec = dataclasses.replace(_as_spec(spec, overrides), stable=True)
    keys = as_keys(keys, resolve_device(spec.device))
    out = _with_overflow_policy(
        lambda s: _sort_one(keys, s, uniform, want_indices=True), spec)
    order = gather_perm_checked(out, "sort_kv")
    return out.gather(), values[order]


def gather(out: SortOutput) -> np.ndarray:
    """Module-level alias for SortOutput.gather()."""
    return out.gather()
