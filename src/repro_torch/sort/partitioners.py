"""Partitioner registry: each sort algorithm as a splitter strategy.

Counterpart of `repro.sort.partitioners`. Sample sort, AMS and HSS share
one three-phase skeleton — local sort, splitter determination, exchange —
and differ only in how the p-1 splitters are found. A `Partitioner`
implements `splitters_batched`; `sharded_batched` runs the skeleton over
the batched engine's (p, B, n_local) rows with one collective per phase
whatever B is (an unbatched sort is B = 1). The port registers "hss"; the
baselines follow with ROADMAP queue 1 item 4.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.exchange import exchange_batched
from repro_torch.core.splitters import (
    SplitterStats, Uniform, hss_splitters_batched)
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm
from repro_torch.sort.spec import SortSpec


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Everything a partitioner sees besides the keys."""

    spec: SortSpec
    comm: Comm
    uniform: Uniform
    initial_probes: Any = None


def null_stats_batched(batch: int, n_satisfied=None,
                       device=None) -> SplitterStats:
    """Placeholder stats for partitioners without per-round diagnostics:
    per-round fields (1, B), rounds_used (B,) ones."""
    z = torch.zeros((1, batch), dtype=torch.int32, device=device)
    sat = (z if n_satisfied is None else torch.as_tensor(
        n_satisfied, dtype=torch.int32, device=device).reshape(1, batch))
    return SplitterStats(gamma_size=z, sample_count=z, overflow=z,
                         n_satisfied=sat,
                         rounds_used=torch.ones((batch,), dtype=torch.int32,
                                                device=device))


class Partitioner:
    """Base strategy. Subclasses implement `splitters_batched`."""

    name: str = "?"

    def splitters_batched(self, local_sorted: torch.Tensor, ctx: ShardCtx):
        """(p, B, n_local) sorted rows -> ((B, p-1) keys, (B, p-1) ranks,
        (B,) overflow, batched stats). Collectives are batch-fused: one
        call per phase, not per request."""
        raise NotImplementedError

    def sharded_batched(self, local: torch.Tensor, ctx: ShardCtx):
        """Full shard-level sort of (p, B, n_local) rows: local sort ->
        splitters -> exchange; B = 1 is the unbatched sort. Returns ((p, B,
        cap), (p, B), keys, ranks, overflow (B,), stats)."""
        local_sorted = dispatch.local_sort(
            local, policy=ctx.spec.kernel_policy)
        keys, ranks, s_ovf, stats = self.splitters_batched(local_sorted, ctx)
        out, n_valid, e_ovf = exchange_batched(
            local_sorted, keys, comm=ctx.comm, cfg=ctx.spec.exchange_config(),
            eps=ctx.spec.eps)
        return out, n_valid, keys, ranks, s_ovf + e_ovf, stats


_REGISTRY: dict[str, Partitioner] = {}


def register_partitioner(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_partitioner(name: str) -> Partitioner:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"sort algorithm {name!r} is not ported yet (ROADMAP queue 1 "
            f"item 4); available: {sorted(_REGISTRY)}") from None


def available_algorithms() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@register_partitioner("hss")
class HSSPartitioner(Partitioner):
    """Histogram Sort with Sampling (the paper's algorithm, Section 4)."""

    def splitters_batched(self, local_sorted, ctx):
        keys, ranks, stats = hss_splitters_batched(
            local_sorted, comm=ctx.comm, cfg=ctx.spec.hss_config(),
            uniform=ctx.uniform, initial_probes=ctx.initial_probes)
        return (keys, ranks,
                torch.zeros((keys.shape[0],), dtype=torch.int32,
                            device=keys.device), stats)
