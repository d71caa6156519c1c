"""Production mesh and the per-arch ParallelCtx (counterpart of
repro.launch.mesh).

The port keeps the reference's mesh shapes, so that every spec and byte
count can be held to the reference's. Single pod: (data 16, model 16),
256 devices; multi-pod: (pod 2, data 16, model 16), 512, the pod axis
joining the FSDP/data group. On H100s that is 256 or 512 cards in 8-card
NVLink nodes: the 16-wide model axis spans two nodes, so its collectives
cross the inter-node network, and across pods only the gradient
reduce-scatter and the parameter all-gather of the data group travel.

A `Mesh` is logical (axis names and sizes, no devices): the port
emulates every shard on one card (`ParallelCtx`), and the dry run
(`launch/dryrun`) reckons each device's shard from the specs.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig
from repro_torch.parallel.ctx import Mesh, ParallelCtx

SINGLE_POD = (("data", "model"), (16, 16))
MULTI_POD = (("pod", "data", "model"), (2, 16, 16))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    names, sizes = MULTI_POD if multi_pod else SINGLE_POD
    return Mesh(names, sizes)


def make_ctx(cfg: ArchConfig, mesh: Mesh, *,
             multi_pod: bool = False) -> ParallelCtx:
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    tp = mesh.shape["model"]
    extra = []
    if cfg.n_kv_heads and cfg.n_kv_heads % tp != 0:
        extra.append(("tp_kv", None))   # replicate small KV-head counts
    return ParallelCtx(
        mesh=mesh,
        dp_axes=dp_axes,
        tp_axis="model",
        shard_heads=cfg.heads_shardable(tp),
        rules_extra=tuple(extra),
    )


__all__ = ["Mesh", "make_ctx", "make_production_mesh"]
