"""ParallelCtx: the parallel layout threaded through the model code.

Counterpart of `repro.parallel.ctx`. The port runs on one device and holds
no mesh: a ctx is the (dp, tp) layout the model code reads, with the
reference's logical-axis rules kept as data (`rules()`; no port module
reads them yet, they wait for the parameter specs of `launch/specs`):

  fsdp      parameter d_model-ish dims, ZeRO-3 sharded over the data axes
  tp        tensor-parallel dims (d_ff, experts, vocab, sharded heads)
  tp_heads  attention head dims: 'model' when head counts divide the TP
            size, else None (attention falls back to context sharding)
  dp        batch dims of activations
  sp        context/sequence dim of activations (sequence parallelism)

The reference's sharding constraints (`repro.parallel.sharding.shard`)
only pin layouts, so the port's model code leaves them out. What the
layout changes in the arithmetic is emulated on the one device, as the
sort emulates its p shards: a `tp_size` of t > 1 runs the MoE layer's
expert-parallel dispatch over `TPComm(t)` (`comm()`) and, with
`shard_heads=False`, the context-parallel attention's t query shards.
`dp_size > 1` is not ported, nor the reference's `tp_seq_collectives`
and `rules_extra` (they only change sharding constraints).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

from repro_torch.parallel.comm import Comm


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    tp_size: int = 1
    dp_size: int = 1
    shard_heads: bool = True       # False => replicate heads, shard context
    seq_parallel: bool = True      # shard residual-stream context over TP
    # the reference's mesh axis names, which rules() resolves to
    dp_axes: ClassVar[tuple] = ("data",)
    tp_axis: ClassVar[str] = "model"

    def __post_init__(self):
        if self.dp_size != 1:
            raise NotImplementedError(
                f"dp_size={self.dp_size}: the port runs one data-parallel "
                "replica (ROADMAP queue 1)")
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {self.tp_size}")

    def rules(self) -> dict:
        return {
            "fsdp": self.dp_axes,
            "tp": self.tp_axis,
            "tp_exp": self.tp_axis,
            "tp_heads": self.tp_axis if self.shard_heads else None,
            "dp": self.dp_axes,
            "sp": (self.tp_axis if not self.shard_heads else None),
            "sp_seq": (self.tp_axis if self.seq_parallel else None),
            "sp_always": self.tp_axis,
            None: None,
        }

    def comm(self) -> "TPComm":
        """The collectives over the emulated tp shards."""
        return TPComm(self.tp_size)


class TPComm(Comm):
    """`Comm` over the tp shards, logged under the tp axis's name, with
    the reference's pmean (psum / t) for replicated statistics."""

    axis = ParallelCtx.tp_axis

    def pmean(self, x):
        self._call(x, "pmean")
        return (x.sum(dim=0) / self.p).to(x.dtype)


def local_ctx() -> ParallelCtx:
    """The (1, 1) layout: one data replica, one tp shard."""
    return ParallelCtx()
