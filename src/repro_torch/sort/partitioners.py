"""Partitioner registry: each sort algorithm as a splitter strategy.

Counterpart of `repro.sort.partitioners`. Sample sort, AMS and HSS share
one three-phase skeleton — local sort, splitter determination, exchange —
and differ only in how the p-1 splitters are found. A `Partitioner`
implements `splitters`; `sharded` runs the skeleton over the (p, n_local)
shard rows. The port registers "hss"; the baselines follow with ROADMAP
queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.exchange import exchange
from repro_torch.core.splitters import Uniform, hss_splitters
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


class Partitioner:
    """Base strategy. Subclasses implement `splitters`."""

    name: str = "?"

    def splitters(self, local_sorted: torch.Tensor, ctx: ShardCtx):
        """-> (splitter_keys (p-1,), splitter_ranks (p-1,), overflow,
        stats)."""
        raise NotImplementedError

    def sharded(self, local: torch.Tensor, ctx: ShardCtx):
        """Full shard-level sort of (p, n_local) rows: local sort ->
        splitters -> exchange. Returns (out, n_valid, keys, ranks,
        overflow, stats)."""
        local_sorted = dispatch.local_sort(local,
                                           policy=ctx.spec.kernel_policy)
        keys, ranks, s_ovf, stats = self.splitters(local_sorted, ctx)
        out, n_valid, e_ovf = exchange(
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
            f"item 8); available: {sorted(_REGISTRY)}") from None


def available_algorithms() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@register_partitioner("hss")
class HSSPartitioner(Partitioner):
    """Histogram Sort with Sampling (the paper's algorithm, Section 4)."""

    def splitters(self, local_sorted, ctx):
        keys, ranks, stats = hss_splitters(
            local_sorted, comm=ctx.comm, cfg=ctx.spec.hss_config(),
            uniform=ctx.uniform, initial_probes=ctx.initial_probes)
        return (keys, ranks,
                torch.zeros((), dtype=torch.int32, device=keys.device), stats)
