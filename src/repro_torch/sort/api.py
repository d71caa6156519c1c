"""The sort front door: `sort`, `sort_batched` and `gather` (counterpart
of repro.sort.api).

    from repro_torch.sort import SortSpec, sort, sort_batched
    out = sort(x)                                 # HSS, 8 shards, on the card
    out = sort(x, SortSpec(shards=4, device="cpu"))
    out = sort(x, kernel_policy="torch")          # kwargs override the spec
    out.gather()                                  # flat sorted NumPy array

    outs = sort_batched(xs)                       # xs (B, n): one pipeline
    outs.gather(b)                                # request b, sorted
    views = sort_batched([x0, x1, x2])            # any lengths: one batch
                                                  # per length, input order
    outs = sort(xs, SortSpec(batch=True))         # the same as sort_batched

`x` is a 1-D int32, uint32 or float32 NumPy array or tensor. The overflow
policy is "raise": `out.overflow` is returned on the device, uncounted on
the host, and 0 means the result is exact (no counter is materialised,
as at repro/sort/api.py:294).
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
    """Sort a 1-D key array over `spec.shards` emulated shards. With
    `SortSpec(batch=True)` the input goes to `sort_batched` instead.

    `uniform` (optional) injects the sampling draws: round j ->
    (p, n_local) float32 U[0, 1) array, row s for shard s, in place of the
    seeded generator (the parity tests feed the reference's draws)."""
    spec = _as_spec(spec, overrides)
    if spec.batch:
        return sort_batched(x, spec, uniform=uniform)
    x = as_keys(x, resolve_device(spec.device))
    if x.dim() != 1:
        raise ValueError(f"sort expects a 1-D key array, got {tuple(x.shape)}")
    # one request through the batched engine, the batch axis squeezed out
    if spec.initial_probes is not None:
        spec = dataclasses.replace(
            spec, initial_probes=as_keys(spec.initial_probes, x.device)[None])
    out = _sort_batched_impl(x[None], spec, uniform).request(0)
    if out.stats is not None:
        out.stats = type(out.stats)(*(f[..., 0] for f in out.stats))
    return out


def sort_batched(xs, spec: SortSpec | None = None, *, uniform=None,
                 **overrides):
    """Sort B independent key arrays in one pipeline.

    xs: a (B, n) array of B equal-length requests — returns a
    BatchedSortOutput — or a list or tuple of 1-D arrays of any lengths,
    which is bucketed by length (`group_by_length`; one batch per distinct
    length) and returns a list of per-request SortOutput views in input
    order. Per request the result is bit-identical to `sort()` of that
    request with the same spec and seed when both plans agree (fix `tag`:
    a batch shares one adapter plan); each collective is one call per
    phase whatever B is. `uniform` is as in `sort`: every request shares
    the shards' draws.
    """
    spec = _as_spec(spec, overrides)
    if isinstance(xs, (list, tuple)):
        return _sort_batched_buckets(xs, spec, uniform)
    return _sort_batched_impl(xs, spec, uniform)


def _sort_batched_impl(xs, spec: SortSpec, uniform) -> BatchedSortOutput:
    part = get_partitioner(spec.algorithm)
    dev = resolve_device(spec.device)
    xs = as_keys(xs, dev)
    if xs.dim() != 2:
        raise ValueError(
            f"sort_batched expects a (B, n) key array, got {tuple(xs.shape)}")
    p = spec.shards

    plan = make_plan(xs, spec, p)
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
        out = _sort_batched_impl(torch.stack([arrs[i] for i in idxs]), spec,
                                 uniform)
        for j, i in enumerate(idxs):
            results[i] = out.request(j)
    return results


def gather(out: SortOutput) -> np.ndarray:
    """Module-level alias for SortOutput.gather()."""
    return out.gather()
