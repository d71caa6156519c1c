"""Abstract inputs and their shardings for every (arch x shape) cell
(counterpart of repro.launch.specs).

Tensors on the `meta` device stand in for the reference's
ShapeDtypeStructs (shapes and dtypes, no storage), and a `Sharding(mesh,
spec)` for its NamedSharding. The port has no compiler to reject an
incoherent layout, so `Sharding.shard_shape` is the check: it raises when
a sharded dimension does not divide by its axes' size, where the
reference's jit would refuse the layout.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.shapes import Shape
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import init_cache
from repro_torch.models.params import param_pspecs
from repro_torch.parallel.ctx import Mesh, ParallelCtx, PSpec, map_specs


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A PSpec over a mesh: which shard of a global tensor each device
    holds."""

    mesh: Mesh
    spec: PSpec

    def shard_shape(self, shape) -> tuple:
        """The per-device shard of a global `shape`; raises ValueError
        when a sharded dimension does not divide."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {shape}")
        out = []
        for i, n in enumerate(shape):
            k = math.prod(self.mesh.shape[a] for a in self.spec.axes(i))
            if n % k:
                raise ValueError(f"dimension {i} of {shape} ({n}) does not "
                                 f"split over {self.spec.axes(i)} ({k})")
            out.append(n // k)
        return tuple(out)

    def shard_bytes(self, t: torch.Tensor) -> int:
        return math.prod(self.shard_shape(t.shape)) * t.element_size()


def _ns(ctx: ParallelCtx, spec: PSpec) -> Sharding:
    return Sharding(ctx.mesh, spec)


def _dp_or_none(ctx: ParallelCtx, n: int):
    """Shard a batch dim over dp only when divisible (long_500k has B=1)."""
    return tuple(ctx.dp_axes) if n % max(ctx.dp_size, 1) == 0 and \
        n >= ctx.dp_size else None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: Shape, ctx: ParallelCtx):
    """Abstract batch + shardings for a train/prefill step."""
    b, s = shape.global_batch, shape.seq_len
    dp = _dp_or_none(ctx, b)
    dt = getattr(torch, cfg.dtype)
    specs, shards = {}, {}
    if cfg.embed_inputs:
        specs["embeds"] = _meta((b, s, cfg.d_model), dt)
        shards["embeds"] = _ns(ctx, PSpec(dp, None, None))
    else:
        specs["tokens"] = _meta((b, s), torch.int32)
        shards["tokens"] = _ns(ctx, PSpec(dp, None))
    if cfg.family == "encdec":
        specs["tokens"] = _meta((b, s), torch.int32)
        shards["tokens"] = _ns(ctx, PSpec(dp, None))
        specs["enc"] = _meta((b, cfg.enc_ctx, cfg.d_model), dt)
        shards["enc"] = _ns(ctx, PSpec(dp, None, None))
    if shape.kind == "train":
        specs["labels"] = _meta((b, s), torch.int32)
        shards["labels"] = _ns(ctx, PSpec(dp, None))
    return specs, shards


def cache_pspecs(cfg: ArchConfig, ctx: ParallelCtx, batch: int):
    """Spec tree matching init_cache: KV caches shard their *head* dim
    over TP when kv_heads divides it; otherwise the context dim. Batch
    over dp when divisible; SSM inner dims over TP."""
    dp = _dp_or_none(ctx, batch)
    tp = ctx.tp_axis
    tp_n = ctx.tp_size
    if cfg.n_kv_heads and tp_n > 1 and cfg.n_kv_heads % tp_n == 0:
        kv = PSpec(None, dp, None, tp, None)
    else:
        kv = PSpec(None, dp, tp, None, None)
    kv_spec = (kv, kv)
    ssm = {"conv_x": PSpec(None, dp, None, tp),
           "conv_B": PSpec(None, dp, None, None),
           "conv_C": PSpec(None, dp, None, None),
           "state": PSpec(None, dp, tp, None, None)}
    if cfg.family in ("dense", "vlm", "moe"):
        return {"kv": kv_spec}
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        return {"mamba": ssm, "shared_kv": kv_spec}
    if cfg.family == "encdec":
        return {"dec": {"kv": kv_spec}, "enc_out": PSpec(dp, None, None)}
    raise ValueError(cfg.family)


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int, ctx):
    return init_cache(cfg, batch, max_seq, ctx, device="meta")


def decode_specs(cfg: ArchConfig, shape: Shape, ctx: ParallelCtx):
    """(cache, tokens, pos) abstract values + shardings for serve_step."""
    b, s = shape.global_batch, shape.seq_len
    dp = _dp_or_none(ctx, b)
    dt = getattr(torch, cfg.dtype)
    cache = abstract_cache(cfg, b, s, ctx)
    cache_sh = tree_named(ctx, cache_pspecs(cfg, ctx, b))
    if cfg.embed_inputs:
        tokens = _meta((b, 1, cfg.d_model), dt)
        tok_sh = _ns(ctx, PSpec(dp, None, None))
    else:
        tokens = _meta((b, 1), torch.int32)
        tok_sh = _ns(ctx, PSpec(dp, None))
    pos = _meta((), torch.int32)
    return (cache, tokens, pos), (cache_sh, tok_sh, _ns(ctx, PSpec()))


def tree_named(ctx: ParallelCtx, pspec_tree):
    """Wrap every PSpec leaf (or None) into a Sharding."""
    return map_specs(lambda sp: _ns(ctx, sp if sp is not None else PSpec()),
                     pspec_tree)


def param_shardings(cfg: ArchConfig, ctx: ParallelCtx):
    return tree_named(ctx, param_pspecs(cfg, ctx))
