"""Partitioner registry: each sort algorithm as a splitter strategy.

Counterpart of `repro.sort.partitioners`. Sample sort, AMS and HSS share
one three-phase skeleton — local sort, splitter determination, exchange —
and differ only in how the p-1 splitters are found. A `Partitioner`
implements `splitters_batched`; `sharded_batched` runs the skeleton over
the batched engine's (p, B, n_local) rows with one collective per phase
whatever B is (an unbatched sort is B = 1). Multistage runs two nested
exchanges, so it overrides the whole `sharded_batched`.

The draws (`ShardCtx.uniform`, (j, n) -> (p, n)) are numbered per
algorithm, as each of the reference's consumes its per-shard key: HSS
takes draw j in round j (one split a round); sample_random and ams take
draw 0 once, of n_local keys (the key itself, no split);
sample_regular takes none; multistage takes stage 1's rounds as draws
0..k1-1 and stage 2's as k1.., of the stage-1 output row's length (the
key split in two, then one split a round in each stage).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.analysis.contracts import CommsContract, register_contract
from repro_torch.core.ams import ams_splitters
from repro_torch.core.exchange import (
    BATCH_FUSED_STRATEGIES, EXCHANGE_COLLECTIVES, exchange_batched)
from repro_torch.core.multistage import two_stage_sort_batched
from repro_torch.core.sample_sort import (
    default_regular_s, default_total_sample, random_sample_splitters,
    regular_sample_splitters)
from repro_torch.core.splitters import (
    ROUND_COLLECTIVES, SplitterStats, hss_splitters_batched)
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm
from repro_torch.sort.driver import factor_stages
from repro_torch.sort.spec import SortSpec


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Everything a partitioner sees besides the keys. uniform: (j, n) ->
    (p, n) draws, row s for shard s."""

    spec: SortSpec
    comm: Comm
    uniform: Callable[[int, int], torch.Tensor]
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


def _zeros(batch: int, device) -> torch.Tensor:
    return torch.zeros((batch,), dtype=torch.int32, device=device)


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

    def partition_sorted_batched(self, local_sorted: torch.Tensor,
                                 ctx: ShardCtx, *, n_valid=None,
                                 ex_cfg=None):
        """Splitters + exchange over already sorted (p, B, n_local) rows:
        the relaxed seam of the semisort light path (partitioners.py:
        158-188). The caller owns the local sort and may mask a tail as
        hi-sentinel padding, giving the real count of each (shard,
        request) row in `n_valid` ((p, B), (B,) or a scalar) so the
        exchange leaves the pads out of the last slice. The splitter
        rounds see the sentinel tail as real maximum keys, which only
        biases the top splitters up: grouping, not total order, is the
        contract here. Returns as `sharded_batched`."""
        keys, ranks, s_ovf, stats = self.splitters_batched(local_sorted, ctx)
        out, n_out, e_ovf = exchange_batched(
            local_sorted, keys, comm=ctx.comm,
            cfg=ex_cfg if ex_cfg is not None else ctx.spec.exchange_config(),
            eps=ctx.spec.eps, n_valid=n_valid)
        return out, n_out, keys, ranks, s_ovf + e_ovf, stats

    def partition_sorted(self, local_sorted: torch.Tensor, ctx: ShardCtx,
                         *, n_valid=None, ex_cfg=None):
        """`partition_sorted_batched` of one request: (p, n_local) sorted
        rows, n_valid None, a scalar or (p,) -> (out (p, cap), n_out (p,),
        keys (p-1,), ranks (p-1,), overflow scalar, stats per request)."""
        nv = None if n_valid is None else torch.as_tensor(n_valid)
        if nv is not None and nv.dim() == 1:
            nv = nv[:, None]
        out, n_out, keys, ranks, ovf, stats = self.partition_sorted_batched(
            local_sorted[:, None], ctx, n_valid=nv, ex_cfg=ex_cfg)
        return (out[:, 0], n_out[:, 0], keys[0], ranks[0], ovf[0],
                type(stats)(*(f[..., 0] for f in stats)))


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
        raise ValueError(
            f"unknown sort algorithm {name!r}; available: "
            f"{sorted(_REGISTRY)}") from None


def available_algorithms() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# Wire contracts of the splitter phases, one per algorithm (counterpart of
# repro/sort/partitioners.py:216-246), proved by `python -m
# repro_torch.analysis.lint` over `analysis.programs.splitters_program`.
# The port counts calls as they run (repro_torch.analysis.contracts):
# total_counts are the calls OUTSIDE every splitter round and
# round_collectives those of EVERY round that ran, so HSS's and AMS's
# round calls sit under round_collectives where the reference counts
# its round body once in its totals. A splitter phase exchanges no
# payload, so every contract bans all_to_all. The full pipeline's totals
# are these plus the strategy's `exchange:<strategy>` contract below.
_BATCH_INVARIANT = ("all_gather", "all_to_all", "psum", "ppermute",
                    "ragged_all_to_all")
_NO_ROUND_CALLS = {"all_gather": 0, "psum": 0, "all_to_all": 0}

register_contract("splitters:hss", CommsContract(
    name="splitters:hss",
    description="k-round histogram refinement: ONE sample all_gather and "
                "ONE fused rank/meta psum in every round that runs, none "
                "outside the rounds, and no call after the host's early "
                "exit fires",
    total_counts=dict(_NO_ROUND_CALLS),
    round_collectives=dict(ROUND_COLLECTIVES),
    converged_branch_pure=True,
    batch_invariant=_BATCH_INVARIANT))

register_contract("splitters:sample_random", CommsContract(
    name="splitters:sample_random",
    description="one Bernoulli sample all_gather + overflow/valid psums",
    total_counts={"all_gather": 1, "psum": 2, "all_to_all": 0},
    batch_invariant=_BATCH_INVARIANT))

register_contract("splitters:sample_regular", CommsContract(
    name="splitters:sample_regular",
    description="one regular-sample all_gather, fully deterministic",
    total_counts={"all_gather": 1, "psum": 0, "all_to_all": 0},
    batch_invariant=_BATCH_INVARIANT))

register_contract("splitters:ams", CommsContract(
    name="splitters:ams",
    description="its one round: the sample all_gather, the overflow psum "
                "and ONE fused histogram psum; the scan communicates "
                "nothing",
    total_counts=dict(_NO_ROUND_CALLS),
    round_collectives={"all_gather": 1, "psum": 2},
    batch_invariant=_BATCH_INVARIANT))

# The exchange strategies' contracts: the port's own table
# (core.exchange.EXCHANGE_COLLECTIVES), which differs from the
# reference's in two places on purpose (ROADMAP queue 3 item 16).
_EXCHANGE_NOTES = {
    "dense": "capacity-padded all_to_all of keys and counts, the send "
             "overflow psum and the receive truncation psum",
    "dense_spill": "the dense channel's two all_to_all, the spill rows' "
                   "and counts' all_gather and the truncation psum; one "
                   "request at a time, so it is not batch-fused",
    "allgather": "payload and counts all_gather and the truncation psum",
    "ragged": "counts and offsets all_to_all around one ragged_all_to_all, "
              "plus a truncation psum the reference's row lacks, and "
              "batch-fused where the reference loops over requests "
              "(ROADMAP queue 3 item 16)",
}
for _strategy, _calls in EXCHANGE_COLLECTIVES.items():
    register_contract(f"exchange:{_strategy}", CommsContract(
        name=f"exchange:{_strategy}",
        description=_EXCHANGE_NOTES[_strategy],
        total_counts=dict(_calls),
        forbid=("ppermute",),
        batch_invariant=(_BATCH_INVARIANT
                         if _strategy in BATCH_FUSED_STRATEGIES else ())))


@register_partitioner("hss")
class HSSPartitioner(Partitioner):
    """Histogram Sort with Sampling (the paper's algorithm, Section 4)."""

    def splitters_batched(self, local_sorted, ctx):
        n_local = local_sorted.shape[-1]
        keys, ranks, stats = hss_splitters_batched(
            local_sorted, comm=ctx.comm, cfg=ctx.spec.hss_config(),
            uniform=lambda j: ctx.uniform(j, n_local),
            initial_probes=ctx.initial_probes)
        return keys, ranks, _zeros(keys.shape[0], keys.device), stats


@register_partitioner("sample_random")
class RandomSamplePartitioner(Partitioner):
    """Random-sampling sample sort (Blelloch et al.; Theorem 3.1)."""

    def splitters_batched(self, local_sorted, ctx):
        p, batch, n_local = local_sorted.shape
        total = ctx.spec.total_sample or default_total_sample(
            p, n_local, ctx.spec.eps)
        keys, overflow = random_sample_splitters(
            local_sorted, comm=ctx.comm, total_sample=total,
            u=ctx.uniform(0, n_local), kernel_policy=ctx.spec.kernel_policy)
        return (keys, torch.zeros_like(keys, dtype=torch.int32), overflow,
                null_stats_batched(batch, device=keys.device))


@register_partitioner("sample_regular")
class RegularSamplePartitioner(Partitioner):
    """Regular-sampling sample sort (PSRS; Theorem 3.2). Deterministic."""

    def splitters_batched(self, local_sorted, ctx):
        p, batch, _ = local_sorted.shape
        keys = regular_sample_splitters(
            local_sorted, comm=ctx.comm,
            s=ctx.spec.s or default_regular_s(p, ctx.spec.eps),
            kernel_policy=ctx.spec.kernel_policy)
        return (keys, torch.zeros_like(keys, dtype=torch.int32),
                _zeros(batch, keys.device),
                null_stats_batched(batch, device=keys.device))


@register_partitioner("ams")
class AMSPartitioner(Partitioner):
    """Single-stage AMS scanning baseline (Section 3.6, Appendix A);
    stats.n_satisfied is p-1 where the scan succeeded, else 0."""

    def splitters_batched(self, local_sorted, ctx):
        p, batch, n_local = local_sorted.shape
        keys, ranks, overflow, ok = ams_splitters(
            local_sorted, comm=ctx.comm, eps=ctx.spec.eps,
            u=ctx.uniform(0, n_local), total_sample=ctx.spec.total_sample,
            kernel_policy=ctx.spec.kernel_policy)
        sat = torch.where(ok, p - 1, 0).to(torch.int32)
        return keys, ranks, overflow, null_stats_batched(
            batch, sat, device=keys.device)


#: Collectives of the two-stage pipeline outside its exchanges and its
#: rounds (counterpart of repro/sort/partitioners.py:368): the group-size
#: psum. Each round of either stage makes MULTISTAGE_ROUND_COLLECTIVES
#: (one all_gather, three psums: ranks, sample count, sample overflow).
#: The reference's base, all_gather 2 and psum 7, is both round bodies
#: counted once plus that psum. A stage's exchange runs every group of
#: the stage as one batched call (`Comm.along`), so a batch-fused
#: strategy adds its row twice (once a stage), as the reference's does,
#: and dense_spill, one request at a time, adds it once for each of the
#: r2 stage-1 rows and the r1 stage-2 rows.
MULTISTAGE_BASE_COLLECTIVES = {"all_gather": 0, "psum": 1, "all_to_all": 0}
MULTISTAGE_ROUND_COLLECTIVES = {"all_gather": 1, "psum": 3}


def multistage_exchange_calls(strategy: str, r1: int, r2: int) -> int:
    """How many exchanges of `strategy` the two-stage pipeline makes."""
    return 2 if strategy in BATCH_FUSED_STRATEGIES else r1 + r2


@register_partitioner("multistage")
class MultistagePartitioner(Partitioner):
    """Two-stage HSS (Sections 5.3/6.1): group split + intra-group sort.
    It has no final splitters of its own: keys and ranks come back (B, 0),
    the stats as placeholders, as the reference's do."""

    def sharded_batched(self, local, ctx):
        r1, r2 = ctx.spec.stages or factor_stages(ctx.spec.shards)
        out, n_valid, overflow = two_stage_sort_batched(
            local, comm=ctx.comm, r1=r1, r2=r2, uniform=ctx.uniform,
            hss_cfg=ctx.spec.hss_config(), ex_cfg=ctx.spec.exchange_config())
        batch, dev = local.shape[1], local.device
        return (out, n_valid,
                torch.zeros((batch, 0), dtype=local.dtype, device=dev),
                torch.zeros((batch, 0), dtype=torch.int32, device=dev),
                overflow, null_stats_batched(batch, device=dev))
