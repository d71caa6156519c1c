"""SortSpec: the configuration object of the `repro_torch.sort` front door.

Counterpart of `repro.sort.spec.SortSpec`, with the fields the ported
paths read. The reference's `mesh` gives way to `shards` (p, emulated as
the leading axis of one tensor), `stages` (multistage's (r1, r2) grid,
the reference's 2-D mesh shape) and `device` ("cuda" by default; the
tests pass "cpu").

    from repro_torch.sort import SortSpec, sort
    out = sort(x, SortSpec(shards=8, eps=0.05))
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.common import HSSConfig
from repro_torch.core.exchange import ExchangeConfig

ALGORITHMS = ("hss", "sample_random", "sample_regular", "ams", "multistage")

ON_OVERFLOW = ("raise", "retry", "spill")

VERIFY = ("off", "cheap", "full")

ON_VERIFY_FAILURE = ("raise", "retry", "fallback")


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """Everything `sort()` needs.

      algorithm      one of ALGORITHMS (repro_torch.sort.partitioners):
                     "hss", the baselines "sample_random",
                     "sample_regular" and "ams", or "multistage".
      eps            load-balance slack: each shard <= (1+eps) N/p keys.
      rounds, sample_per_shard, adaptive   forwarded to HSSConfig (hss
                     and multistage).
      total_sample   sample_random and ams: the overall sample size
                     (None: each algorithm's theory size).
      s              sample_regular: keys sampled a shard (None: p/eps).
      stages         multistage: the (r1, r2) grid, r1*r2 == shards
                     (None: `driver.factor_stages(shards)`).
      exchange       "dense", "dense_spill", "ragged" or "allgather".
      pair_factor    dense: per-(src, dst) capacity multiplier.
      out_slack      output-buffer slack on the (1+eps) capacity.
      on_overflow    "raise": `sort()` reports the overflow counter for the
                     caller to check; `argsort`/`sort_kv` raise on a short
                     gather. "retry": the counter is read on the host once
                     per launch and, while nonzero, the sort runs again
                     with `capacity_scale` doubled, warm-started from the
                     failed attempt's splitters; after
                     `max_overflow_retries` escalations one last attempt
                     runs on the spill channel, and only if that truncates
                     too does it raise. "spill": the dense exchange is
                     swapped for dense_spill, which drops no key on the
                     send side.
      max_overflow_retries  escalations of "retry" before the spill attempt.
      capacity_scale uniform multiplier on every static buffer.
      verify         the fused output audit (repro_torch.sort.verify): "off"
                     (no audit), "cheap" (2 fingerprint lanes, 64 bits)
                     or "full" (4 lanes): multiset fingerprint, count,
                     sortedness, boundary and splitter-range checks, one
                     psum and one ppermute more, one host copy a launch.
      on_verify_failure  what a failed audit does: "raise" a
                     VerificationError (BatchVerificationError on the
                     batched path, with per-row verdicts); "retry" once,
                     then the fallback; "fallback": re-run on the spill
                     channel under kernel_policy="torch", raising only if
                     that fails too. Attempts land on `RecoveryStats`.
      imbalance_slo  enforce achieved_imbalance = max shard load / (N/p)
                     <= this bound: when missed, re-run with duplicate
                     tagging, then with bonus refinement, and raise
                     ImbalanceError only if both miss. None records
                     achieved_imbalance (when verify is on) and enforces
                     nothing.
      semisort_sample  per-shard sample of `semisort`'s heavy-hitter
                     detection (0: max(64, 8p)). Ignored by `sort()`.
      heavy_fraction `semisort`: a key is heavy when its estimated count
                     reaches heavy_fraction * N / p.
      shards         p, the number of emulated shards.
      device         where the sort runs: "cuda" (default) or "cpu".
      batch          route `sort()` through the batched engine: a (B, n)
                     array or a list of 1-D arrays (see `sort_batched`).
      stable, tag    duplicate tagging (paper Sec. 6.3): stable=True or
                     tag=True always tags (`argsort`/`sort_kv` force it),
                     tag=False never does, tag=None tags when duplicates
                     are detected and the packing fits int32.
      kernel_policy  "auto" | "kernel" | "torch" (repro_torch.kernels
                     .dispatch); every choice gives the same bits.
      seed           seed of the sampling rounds' torch.Generator.
      initial_probes warm-start probes in the key domain (paper Sec. 7.3).
    """

    algorithm: str = "hss"
    eps: float = 0.05
    rounds: int = 0
    sample_per_shard: int = 0
    adaptive: bool = True
    total_sample: int | None = None
    s: int | None = None
    stages: tuple[int, int] | None = None
    exchange: str = "dense"
    pair_factor: float = 3.0
    out_slack: float = 1.0
    on_overflow: str = "raise"
    max_overflow_retries: int = 3
    capacity_scale: float = 1.0
    verify: str = "off"
    on_verify_failure: str = "raise"
    imbalance_slo: float | None = None
    semisort_sample: int = 0
    heavy_fraction: float = 0.5
    shards: int = 8
    device: str = "cuda"
    batch: bool = False
    stable: bool = False
    tag: bool | None = None
    kernel_policy: str = "auto"
    seed: int = 0
    initial_probes: Any = None

    def __post_init__(self):
        if self.on_overflow not in ON_OVERFLOW:
            raise ValueError(
                f"on_overflow must be one of {ON_OVERFLOW}, "
                f"got {self.on_overflow!r}")
        if self.verify not in VERIFY:
            raise ValueError(
                f"verify must be one of {VERIFY}, got {self.verify!r}")
        if self.on_verify_failure not in ON_VERIFY_FAILURE:
            raise ValueError(
                f"on_verify_failure must be one of {ON_VERIFY_FAILURE}, "
                f"got {self.on_verify_failure!r}")
        if self.imbalance_slo is not None and self.imbalance_slo < 1.0:
            raise ValueError(
                f"imbalance_slo is max_shard_load/(N/p), necessarily >= 1; "
                f"got {self.imbalance_slo!r}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.stages is not None and (
                len(self.stages) != 2
                or self.stages[0] * self.stages[1] != self.shards):
            raise ValueError(f"stages {self.stages} must be two factors of "
                             f"shards={self.shards}")

    def resolved_exchange(self) -> str:
        """The exchange after the overflow policy: "spill" swaps the
        capacity-dropping dense exchange for dense_spill; the exact
        strategies stay as they are."""
        if self.on_overflow == "spill" and self.exchange == "dense":
            return "dense_spill"
        return self.exchange

    def overflow_structurally_zero(self) -> bool:
        """True when the exchange cannot drop keys on the send side and
        the (1+eps) guarantee sizes the receive buffers, so the overflow
        counter needs no host check on the happy path. The reference's
        predicate, strategy for strategy."""
        return self.resolved_exchange() in ("ragged", "dense_spill",
                                            "allgather")

    def hss_config(self) -> HSSConfig:
        return HSSConfig(eps=self.eps, rounds=self.rounds,
                         sample_per_shard=self.sample_per_shard,
                         adaptive=self.adaptive, out_slack=self.out_slack,
                         capacity_scale=self.capacity_scale,
                         kernel_policy=self.kernel_policy)

    def exchange_config(self) -> ExchangeConfig:
        return ExchangeConfig(strategy=self.resolved_exchange(),
                              pair_factor=self.pair_factor,
                              out_slack=self.out_slack,
                              capacity_scale=self.capacity_scale,
                              kernel_policy=self.kernel_policy)
