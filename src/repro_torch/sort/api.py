"""The sort front door: `sort` and `gather` (counterpart of repro.sort.api).

    from repro_torch.sort import SortSpec, sort
    out = sort(x)                                 # HSS, 8 shards, on the card
    out = sort(x, SortSpec(shards=4, device="cpu"))
    out = sort(x, kernel_policy="torch")          # kwargs override the spec
    out.gather()                                  # flat sorted NumPy array

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
from repro_torch.sort.adapters import SortOutput, as_keys, make_plan
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
    """Sort a 1-D key array over `spec.shards` emulated shards.

    `uniform` (optional) injects the sampling draws: round j ->
    (p, n_local) float32 U[0, 1) array, row s for shard s, in place of the
    seeded generator (the parity tests feed the reference's draws)."""
    spec = _as_spec(spec, overrides)
    part = get_partitioner(spec.algorithm)
    dev = resolve_device(spec.device)
    x = as_keys(x, dev)
    if x.dim() != 1:
        raise ValueError(f"sort expects a 1-D key array, got {tuple(x.shape)}")
    p = spec.shards

    plan = make_plan(x, spec, p)
    enc = plan.encode(x)
    probes = (plan.encode_probes(spec.initial_probes)
              if spec.initial_probes is not None else None)

    def sort_fn(rows, comm, draws):
        ctx = ShardCtx(spec=spec, comm=comm, uniform=draws,
                       initial_probes=probes)
        return part.sharded(rows, ctx)

    raw = driver.run(sort_fn, enc, p=p, seed=spec.seed, n_real=plan.n,
                     local_sort_fn=dispatch.local_sort_fn(spec.kernel_policy),
                     uniform=uniform)
    return plan.decode(raw)


def gather(out: SortOutput) -> np.ndarray:
    """Module-level alias for SortOutput.gather()."""
    return out.gather()
