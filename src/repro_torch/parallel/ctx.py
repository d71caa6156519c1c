"""ParallelCtx: the parallel layout threaded through the model code.

Counterpart of `repro.parallel.ctx`. A ctx is a logical mesh (`Mesh`:
ordered axis names and sizes, no devices), the data axes and the tensor
axis over it, and the reference's logical-axis rules:

  fsdp      parameter d_model-ish dims, ZeRO-3 sharded over the data axes
  tp        tensor-parallel dims (d_ff, experts, vocab, sharded heads)
  tp_heads  attention head dims: 'model' when head counts divide the TP
            size, else None (attention falls back to context sharding)
  dp        batch dims of activations
  sp        context/sequence dim of activations (sequence parallelism)

`spec(*names)` maps logical names through the rules to a `PSpec`, the
counterpart of a PartitionSpec; `models.params.param_pspecs`,
`optim`'s `state_pspecs` and `launch/specs` build on it.

The port runs on one device. The reference's sharding constraints only
pin layouts, so the port's model code leaves them out, and what a layout
changes in the arithmetic is emulated on the one device, as the sort
emulates its p shards: the dp x tp grid's shards are the leading axis of
one tensor (`comm()`, a `Comm` over the grid). Of the fields only the dp
and tp sizes change arithmetic: the MoE layer cuts each capacity for the
token group of one grid shard and runs its expert-parallel exchange
within each dp group, the decode path splits each expert's d_ff over the
dp shards, and with `shard_heads=False` the context-parallel attention
runs its tp query shards. The other fields are data that `spec()` and the
dry run read.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.parallel.comm import Comm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ordered axis names and their sizes. It holds
    no devices: the port emulates every shard on one card. `shape` maps
    each name to its size, as a jax mesh's does."""

    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        names, sizes = tuple(self.axis_names), tuple(self.axis_sizes)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} and sizes {sizes}")
        if any(int(s) < 1 for s in sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {sizes}")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", tuple(int(s) for s in sizes))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _entry(e):
    """A spec entry as a PartitionSpec keeps it: None, one axis name, or
    a tuple of two or more names (an empty tuple is None, a 1-tuple its
    name)."""
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    if not e:
        return None
    return e[0] if len(e) == 1 else e


class PSpec(tuple):
    """The port's PartitionSpec: one entry a dimension, each None, one
    mesh axis name or a tuple of names. A tuple, so
    `tuple(pspec) == tuple(jax_partition_spec)` compares the two."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return f"PSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple:
        """The mesh axes dimension `dim` is sharded over ((), one or more)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else e


def map_specs(fn, tree):
    """fn over the PSpec (or None) leaves of nested dicts, tuples and
    lists of specs."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, PSpec):
        return type(tree)(map_specs(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True, init=False)
class ParallelCtx:
    mesh: Mesh
    dp_axes: tuple = ("data",)     # e.g. ("pod", "data") or ("data",)
    tp_axis: str | None = "model"  # None: tp 1
    shard_heads: bool = True       # False => replicate heads, shard context
    seq_parallel: bool = True      # shard residual-stream context over TP
    tp_seq_collectives: bool = False  # Megatron-SP constraints (data here)
    rules_extra: tuple = ()

    def __init__(self, mesh: Mesh | None = None, dp_axes=("data",),
                 tp_axis: str | None = "model", shard_heads: bool = True,
                 seq_parallel: bool = True, tp_seq_collectives: bool = False,
                 rules_extra: tuple = (), *, tp_size: int | None = None,
                 dp_size: int | None = None):
        """`mesh` gives the layout; without one, `dp_size` and `tp_size`
        (default 1) build the local mesh over `dp_axes` and `tp_axis`, the
        first data axis taking all of dp."""
        dp_axes = tuple(dp_axes or ())
        if mesh is None:
            dp, tp = dp_size or 1, tp_size or 1
            if dp < 1 or tp < 1:
                raise ValueError(f"dp_size and tp_size must be >= 1, got "
                                 f"{dp_size}, {tp_size}")
            if (dp > 1 and not dp_axes) or (tp > 1 and tp_axis is None):
                raise ValueError(f"dp {dp} over axes {dp_axes}, tp {tp} "
                                 f"over axis {tp_axis}")
            sizes = {a: 1 for a in dp_axes}
            if dp_axes:
                sizes[dp_axes[0]] = dp
            if tp_axis is not None:
                sizes[tp_axis] = tp
            mesh = Mesh(tuple(sizes), tuple(sizes.values()))
        elif tp_size is not None or dp_size is not None:
            raise TypeError("give a mesh or dp_size/tp_size, not both")
        missing = [a for a in dp_axes + (tp_axis,) if a is not None
                   and a not in mesh.shape]
        if missing or tp_axis in dp_axes:
            raise ValueError(f"axes {dp_axes} + {tp_axis!r} on a mesh of "
                             f"{mesh.axis_names}")
        for name, value in (("mesh", mesh), ("dp_axes", dp_axes),
                            ("tp_axis", tp_axis), ("shard_heads", shard_heads),
                            ("seq_parallel", seq_parallel),
                            ("tp_seq_collectives", tp_seq_collectives),
                            ("rules_extra", tuple(rules_extra))):
            object.__setattr__(self, name, value)

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis] if self.tp_axis else 1

    def rules(self) -> dict:
        dp = tuple(self.dp_axes) if self.dp_axes else None
        r = {
            "fsdp": dp,
            "tp": self.tp_axis,
            "tp_exp": self.tp_axis,
            "tp_heads": self.tp_axis if self.shard_heads else None,
            "dp": dp,
            "sp": (self.tp_axis if not self.shard_heads else None),
            "sp_seq": (self.tp_axis if self.seq_parallel else None),
            "sp_always": self.tp_axis,
            None: None,
        }
        r.update(dict(self.rules_extra))
        return r

    def spec(self, *names) -> PSpec:
        rules = self.rules()
        return PSpec(*[rules.get(n, None) for n in names])

    def comm(self) -> "GridComm":
        """The collectives over the emulated dp x tp grid."""
        return GridComm(self.dp_size, self.tp_size,
                        self.dp_axes, self.tp_axis or "model")


class GridComm(Comm):
    """`Comm` over the dp x tp grid of shards: shard s = g * tp + j is
    tp shard j of dp group g (the reference's row-major mesh, the data
    axes leading), its value row s of a (dp * tp, ...) tensor.
    `all_to_all` runs over the tp axis within each dp group; `psum` and
    `pmean` (psum / shards, for replicated statistics) over every axis,
    as the reference's `all_axes` do. Calls are logged under the tp
    axis's name, the all-axes ones under the joined names of the data and
    tp axes when dp > 1."""

    def __init__(self, dp: int, tp: int, dp_axes=("data",),
                 tp_axis: str = "model"):
        super().__init__(dp * tp)
        self.dp, self.tp = dp, tp
        self.axis = tp_axis
        self.all_axes = (tp_axis if dp == 1
                         else ",".join(tuple(dp_axes) + (tp_axis,)))

    def _call_all(self, x: torch.Tensor, name: str):
        axis, self.axis = self.axis, self.all_axes
        try:
            self._call(x, name)
        finally:
            self.axis = axis

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._call_all(x, "psum")
        return x.sum(dim=0, dtype=x.dtype)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        self._call_all(x, "pmean")
        return (x.sum(dim=0) / self.p).to(x.dtype)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x (dp*tp, tp_dst, ...) -> out[g*tp + d, s] = x[g*tp + s, d]."""
        if x.shape[1] != self.tp:
            raise ValueError(
                f"all_to_all: destination axis {x.shape[1]} != tp={self.tp}")
        self._call(x, "all_to_all")
        grid = x.reshape((self.dp, self.tp, self.tp) + x.shape[2:])
        return grid.transpose(1, 2).reshape(x.shape).contiguous()


def local_ctx() -> ParallelCtx:
    """The (1, 1) layout: one data replica, one tp shard."""
    return ParallelCtx()
