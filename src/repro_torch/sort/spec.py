"""SortSpec: the configuration object of the `repro_torch.sort` front door.

Counterpart of `repro.sort.spec.SortSpec`, with the fields the main path
reads. The reference's `mesh` gives way to `shards` (p, emulated as the
leading axis of one tensor) and `device` ("cuda" by default; the tests
pass "cpu").

    from repro_torch.sort import SortSpec, sort
    out = sort(x, SortSpec(shards=8, eps=0.05))
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.common import HSSConfig
from repro_torch.core.exchange import ExchangeConfig

ALGORITHMS = ("hss",)

ON_OVERFLOW = ("raise",)


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """Everything `sort()` needs.

      algorithm      "hss" (the other partitioners: ROADMAP queue 1 item 8).
      eps            load-balance slack: each shard <= (1+eps) N/p keys.
      rounds, sample_per_shard, adaptive   forwarded to HSSConfig.
      exchange       "dense" or "allgather" (dense_spill and ragged: ROADMAP
                     queue 1 item 8).
      pair_factor    dense: per-(src, dst) capacity multiplier.
      out_slack      output-buffer slack on the (1+eps) capacity.
      on_overflow    "raise": `sort()` reports the overflow counter for the
                     caller to check; retry and spill come with ROADMAP
                     queue 1 item 9.
      capacity_scale uniform multiplier on every static buffer.
      shards         p, the number of emulated shards.
      device         where the sort runs: "cuda" (default) or "cpu".
      batch          route `sort()` through the batched engine: a (B, n)
                     array or a list of 1-D arrays (see `sort_batched`).
      stable, tag    duplicate tagging (paper Sec. 6.3): stable=True or
                     tag=True always tags, tag=False never does, tag=None
                     tags when duplicates are detected and the packing fits.
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
    exchange: str = "dense"
    pair_factor: float = 3.0
    out_slack: float = 1.0
    on_overflow: str = "raise"
    capacity_scale: float = 1.0
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
            raise NotImplementedError(
                f"on_overflow={self.on_overflow!r} is not ported yet "
                "(ROADMAP queue 1 item 9); the port has 'raise'")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")

    def hss_config(self) -> HSSConfig:
        return HSSConfig(eps=self.eps, rounds=self.rounds,
                         sample_per_shard=self.sample_per_shard,
                         adaptive=self.adaptive, out_slack=self.out_slack,
                         capacity_scale=self.capacity_scale,
                         kernel_policy=self.kernel_policy)

    def exchange_config(self) -> ExchangeConfig:
        return ExchangeConfig(strategy=self.exchange,
                              pair_factor=self.pair_factor,
                              out_slack=self.out_slack,
                              capacity_scale=self.capacity_scale,
                              kernel_policy=self.kernel_policy)
