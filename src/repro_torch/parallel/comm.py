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
  ragged_all_to_all  (p_src, B, n) -> (p_dst, B, cap): the exact
              alltoallv, each (source, destination) chunk at its own size,
              as one index gather (no host sync)
  ppermute    (p, ...)    -> (p, ...)     x[src] lands at dst for each
              (src, dst) pair; a shard no pair reaches gets zeros
  axis_index  () -> (p,)                  each shard's index

`along(axis, r1, r2)` views the p = r1*r2 shards as a 2-D (outer, inner)
grid, shard s = outer*r2 + inner (the reference's row-major mesh), and
gives the collectives over one axis: the other axis folds into the batch
axis, so one call still moves every group and request.

The batched engine keeps the shard axis leading, (p, B, ...), so the same
three collectives carry B requests: each is still one logged call.

A value the reference keeps replicated on every shard (gathered probes,
psum results, the splitter state) is held ONCE here, not p times. Every
call is counted in `axis_log` by (axis, collective), and `log` sums it by
collective, so tests can hold the port to the reference's
per-round collective contracts (repro.core.splitters.ROUND_COLLECTIVES,
repro.core.exchange.EXCHANGE_COLLECTIVES).

Every call also makes a `CommRecord`: its axis, its collective, the
PER-SHARD operand (the leading shard axis dropped, so an all_gather of a
(p, B, cap) int32 tensor records (B, cap) and 4*B*cap bytes) and the
splitter round it ran in (`with comm.round(j):`, None outside every
round). `early_exit()` marks a round that the host's early exit skipped.
`recording()` collects the records and marks of every Comm the calling
thread uses inside it, in call order: the one stream the cost model
(repro_torch.analysis.comms) and the contracts read.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from collections import Counter
from typing import NamedTuple

import torch

from repro_torch.runtime.syncs import to_device


class CommRecord(NamedTuple):
    """One collective call, as the cost model reads it."""

    axis: str
    collective: str
    shape: tuple        # per-shard operand shape (shard axis dropped)
    dtype: str          # NumPy's name of the operand dtype
    nbytes: int         # per-shard operand bytes
    round: int | None   # the splitter round it ran in, None outside


class CommEvent(NamedTuple):
    """An entry of a `recording()`: kind "call" (record set), "round"
    (a round entered) or "exit" (the host's early exit fired in round
    `j`); `comm` tells the launches apart (one id per root Comm, shared
    by its `along` views)."""

    kind: str
    comm: int
    j: int | None
    record: CommRecord | None = None


_ids = itertools.count()
_local = threading.local()


@contextlib.contextmanager
def recording():
    """Collect the CommEvents of every Comm the calling thread uses inside
    the block, in order, into the list it yields."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    events: list = []
    stack.append(events)
    try:
        yield events
    finally:
        stack.remove(events)


def _emit(event: CommEvent):
    for events in getattr(_local, "stack", ()):
        events.append(event)


class _Shared:
    """The state a Comm shares with its `along` views."""

    def __init__(self):
        self.id = next(_ids)
        self.axis_log: Counter = Counter()
        self.round = None


class Comm:
    """Collectives over `p` emulated shards, with a call log."""

    axis = "sort"       # the name its calls are logged under

    def __init__(self, p: int):
        if p < 1:
            raise ValueError(f"need at least one shard, got p={p}")
        self.p = p
        self._shared = _Shared()
        self.axis_log = self._shared.axis_log

    @property
    def log(self) -> Counter:
        """Calls by collective, summed over the axes."""
        out: Counter = Counter()
        for (_, name), k in self.axis_log.items():
            out[name] += k
        return out

    @contextlib.contextmanager
    def round(self, j: int):
        """Calls inside the block ran in splitter round j."""
        shared = self._shared
        prev, shared.round = shared.round, j
        _emit(CommEvent("round", shared.id, j))
        try:
            yield
        finally:
            shared.round = prev

    def early_exit(self):
        """The host's early exit skipped the current round."""
        _emit(CommEvent("exit", self._shared.id, self._shared.round))

    def _call(self, x: torch.Tensor, name: str):
        if x.shape[0] != self.p:
            raise ValueError(
                f"{name}: leading (shard) axis {x.shape[0]} != p={self.p}")
        self.axis_log[(self.axis, name)] += 1
        shape = tuple(x.shape[1:])
        rec = CommRecord(self.axis, name, shape,
                         str(x.dtype).removeprefix("torch."),
                         math.prod(shape) * x.element_size(),
                         self._shared.round)
        _emit(CommEvent("call", self._shared.id, rec.round, rec))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._call(x, "all_gather")
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._call(x, "psum")
        return x.sum(dim=0, dtype=x.dtype)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.p:
            raise ValueError(
                f"all_to_all: destination axis {x.shape[1]} != p={self.p}")
        self._call(x, "all_to_all")
        return x.transpose(0, 1).contiguous()

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """Shard src sends its block to shard dst for each (src, dst) of
        `perm`; a shard that receives nothing holds zeros, as
        jax.lax.ppermute fills it."""
        self._call(x, "ppermute")
        out = torch.zeros_like(x)
        if perm:
            src, dst = (to_device(list(v), torch.int64, x.device)
                        for v in zip(*perm))
            out[dst] = x[src]
        return out

    def ragged_all_to_all(self, operand: torch.Tensor, output: torch.Tensor,
                          input_offsets: torch.Tensor,
                          send_sizes: torch.Tensor,
                          output_offsets: torch.Tensor) -> torch.Tensor:
        """The exact alltoallv (counterpart of jax.lax.ragged_all_to_all):
        source s sends operand[s, b, input_offsets[s, b, d] :][:
        send_sizes[s, b, d]] to destination d, which receives it at
        output_offsets[s, b, d] of its row b of `output`. operand (p_src,
        B, n); the offsets and sizes (p_src, B, p_dst); output (p_dst, B,
        cap) holds the fill of every slot no chunk covers. Chunks land in
        each destination row in source order, back to back, as the
        exchange lays them out; a chunk past `cap` is cut there (no write
        lands outside the buffer).

        On one device it is a gather: slot j of a destination row takes
        the last source whose chunk starts at or before j (a searchsorted
        over that row's receive offsets)."""
        p, batch, n = operand.shape
        self._call(operand, "ragged_all_to_all")
        cap = output.shape[-1]
        dev = operand.device
        off = output_offsets.permute(2, 1, 0).to(torch.int64).contiguous()
        size = send_sizes.permute(2, 1, 0).to(torch.int64)
        start = input_offsets.permute(2, 1, 0).to(torch.int64)
        j = torch.arange(cap, dtype=torch.int64, device=dev).expand(
            p, batch, cap).contiguous()
        src = torch.clamp(torch.searchsorted(off, j, right=True) - 1, min=0)
        rel = j - torch.gather(off, -1, src)
        del j
        hit = (rel >= 0) & (rel < torch.gather(size, -1, src))
        row = src * batch + torch.arange(batch, dtype=torch.int64,
                                         device=dev)[:, None]
        idx = row * n + torch.gather(start, -1, src) + rel
        del src, rel, row
        vals = operand.reshape(-1)[torch.clamp(idx, 0, operand.numel() - 1)]
        return torch.where(hit, vals, output)

    def along(self, axis: str, r1: int, r2: int) -> "AxisComm":
        """The collectives over one axis of the (r1, r2) grid: "outer" (r1
        shards that share an inner index) or "inner" (r2 shards that share
        an outer index). Calls are logged here too."""
        if r1 * r2 != self.p:
            raise ValueError(f"grid ({r1}, {r2}) != p={self.p} shards")
        return AxisComm(self, axis, r1, r2)

    def axis_index(self, device=None) -> torch.Tensor:
        return torch.arange(self.p, dtype=torch.int32, device=device)


class AxisComm(Comm):
    """`Comm` over one axis of a (r1, r2) shard grid (`Comm.along`).

    `fold` lays (p, B, ...) shard rows out as (r_axis, r_other*B, ...):
    the axis's shards lead and row other*B + b is request b of the group
    at index `other` of the other axis; `unfold` is its inverse, and
    `rows` repeats a per-request (B, ...) value for every group. Its log
    and its round are the parent's, so a pipeline's totals stay in one
    place."""

    def __init__(self, parent: Comm, axis: str, r1: int, r2: int):
        if axis not in ("outer", "inner"):
            raise ValueError(f"axis must be 'outer' or 'inner', got {axis!r}")
        self.p, self.other = (r1, r2) if axis == "outer" else (r2, r1)
        self.axis, self.r1, self.r2 = axis, r1, r2
        self._shared = parent._shared
        self.axis_log = parent.axis_log

    def fold(self, x: torch.Tensor) -> torch.Tensor:
        grid = x.reshape((self.r1, self.r2) + x.shape[1:])
        if self.axis == "inner":
            grid = grid.transpose(0, 1)
        return grid.reshape((self.p, -1) + x.shape[2:]).contiguous()

    def unfold(self, x: torch.Tensor) -> torch.Tensor:
        grid = x.reshape((self.p, self.other, -1) + x.shape[2:])
        if self.axis == "inner":
            grid = grid.transpose(0, 1)
        return grid.reshape((self.r1 * self.r2, -1)
                            + x.shape[2:]).contiguous()

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat((self.other,) + (1,) * (x.dim() - 1))
