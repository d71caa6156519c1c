"""The collective seam: p shards emulated as the leading axis of one tensor.

Counterpart of `repro.parallel.compat.shard_map` and the `jax.lax`
collectives the reference calls inside it. In the port a per-shard value
is one tensor whose leading axis is the shard index, so a collective is a
tensor op over that axis:

  all_gather  (p, ...)    -> (p, ...)     untiled: every shard sees all p
              blocks, held once with the source shard axis leading
  psum        (p, ...)    -> (...)        sum over shards, dtype kept
  all_to_all  (p_src, p_dst, ...) -> (p_dst, p_src, ...)
              split axis 0, concat axis 0: a transpose of the two shard axes
  axis_index  () -> (p,)                  each shard's index

The batched engine keeps the shard axis leading, (p, B, ...), so the same
three collectives carry B requests: each is still one logged call.

A value the reference keeps replicated on every shard (gathered probes,
psum results, the splitter state) is held ONCE here, not p times. Every
call is counted in `log`, so tests can hold the port to the reference's
per-round collective contracts (repro.core.splitters.ROUND_COLLECTIVES,
repro.core.exchange.EXCHANGE_COLLECTIVES).
"""
from __future__ import annotations

from collections import Counter

import torch


class Comm:
    """Collectives over `p` emulated shards, with a call log."""

    def __init__(self, p: int):
        if p < 1:
            raise ValueError(f"need at least one shard, got p={p}")
        self.p = p
        self.log: Counter = Counter()

    def _check(self, x: torch.Tensor, name: str):
        if x.shape[0] != self.p:
            raise ValueError(
                f"{name}: leading (shard) axis {x.shape[0]} != p={self.p}")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, "all_gather")
        self.log["all_gather"] += 1
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, "psum")
        self.log["psum"] += 1
        return x.sum(dim=0, dtype=x.dtype)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, "all_to_all")
        if x.shape[1] != self.p:
            raise ValueError(
                f"all_to_all: destination axis {x.shape[1]} != p={self.p}")
        self.log["all_to_all"] += 1
        return x.transpose(0, 1).contiguous()

    def axis_index(self, device=None) -> torch.Tensor:
        return torch.arange(self.p, dtype=torch.int32, device=device)
