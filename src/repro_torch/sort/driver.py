"""The host-level sort driver (counterpart of repro.sort.driver).

`run` pads the key array to a multiple of p with the hi sentinel, lays it
out as p shard rows, builds the collective seam and the sampling draws,
runs the shard-level `sort_fn`, and strips the pads back out of the
counts. The reference compiles the shard program once per shape and keeps
it in an executable cache; eager PyTorch has no trace to cache, and the
cache's hit-rate counters come with the serving slice (ROADMAP queue 1
item 11).

The shard-level contract: `sort_fn(rows, comm, uniform)` returns
`(out, n_valid, splitter_keys, splitter_ranks, overflow, stats)` with
`out` the (p, cap) sentinel-padded sorted shards and `n_valid` (p,).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.common import hi_sentinel
from repro_torch.parallel.comm import Comm


def pad_to_shards(x: torch.Tensor, p: int):
    """Sentinel-pad x up to a multiple of p. Returns (padded, n_pad)."""
    n_pad = (-x.shape[0]) % p
    if n_pad == 0:
        return x, 0
    pad = torch.full((n_pad,), hi_sentinel(x.dtype), dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad]), n_pad


def strip_sentinel_counts(shards: torch.Tensor, counts: torch.Tensor,
                          n_pad: int = 0,
                          n_restore: torch.Tensor | None = None):
    """Exclude sentinel-valued entries from per-shard valid counts.

    Pads travel through the exchange as ordinary (globally largest) keys.
    Counting the sentinels actually present in each valid prefix stays
    exact even when the exchange dropped keys. Genuine sentinel-valued
    keys (`n_restore`, counted before padding) are indistinguishable from
    pads by value, so only the sentinels present beyond `n_pad` are kept,
    restored to the earliest shards whose prefixes held sentinels (they
    occupy the global tail, so the gather stays sorted). All on device.
    """
    cap = shards.shape[1]
    pos = torch.arange(cap, dtype=torch.int32, device=shards.device)
    valid = pos[None, :] < counts[:, None]
    pads = valid & (shards == hi_sentinel(shards.dtype))
    stripped = pads.sum(dim=1, dtype=torch.int32)
    counts = counts - stripped
    if n_restore is None:
        return counts
    keep = torch.clamp(stripped.sum(dtype=torch.int32) - n_pad, min=0)
    keep = torch.minimum(keep, n_restore)
    before = torch.cumsum(stripped, 0, dtype=torch.int32) - stripped
    restored = torch.clamp(torch.maximum(keep - before,
                                         torch.zeros_like(before)),
                           max=stripped)
    return counts + restored


def default_uniform(p: int, n_local: int, seed: int, device):
    """Round j -> (p, n_local) float32 U[0, 1) draws from one seeded
    `torch.Generator` on `device` (each call draws the next block)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return lambda j: torch.rand((p, n_local), generator=gen, device=device)


def run(sort_fn, x: torch.Tensor, *, p: int, seed: int = 0,
        n_real: int | None = None, local_sort_fn=None, uniform=None):
    """Run a shard-level sort over p emulated shards; returns the raw
    6-tuple (shards (p, cap), counts (p,), keys, ranks, overflow, stats).

    `n_real` (default len(x)) is the real key count for the p == 1 path,
    which sorts the whole array with `local_sort_fn` (rows -> rows) and
    no collectives. `uniform` (round j -> (p, n_local) float32 array)
    overrides the seeded draws; tests inject the reference's own.
    """
    dev = x.device
    n_real = x.shape[0] if n_real is None else n_real
    if p == 1:
        sort_rows = local_sort_fn or (lambda v: torch.sort(v, dim=-1).values)
        out = sort_rows(x[None])
        return (out, torch.full((1,), n_real, dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=x.dtype, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev), None)
    n_sent_real = None
    if x.shape[0] % p:   # count sentinel-valued data keys before padding
        n_sent_real = (x == hi_sentinel(x.dtype)).sum(dtype=torch.int32)
    x, n_pad = pad_to_shards(x, p)
    n_local = x.shape[0] // p
    if uniform is None:
        draws = default_uniform(p, n_local, seed, dev)
    else:
        draws = lambda j: torch.as_tensor(uniform(j), dtype=torch.float32,
                                          device=dev)
    out, counts, keys, ranks, ovf, stats = sort_fn(
        x.reshape(p, n_local), Comm(p), draws)
    if n_pad:   # our sentinel pads may have been counted as keys
        counts = strip_sentinel_counts(out, counts, n_pad=n_pad,
                                       n_restore=n_sent_real)
    return out, counts, keys, ranks, ovf, stats


def masked_concat(shards: torch.Tensor, counts: torch.Tensor) -> np.ndarray:
    """Concatenate the valid prefixes of all shards; returns NumPy.

    One boolean-mask select on device (row-major order is the shard
    order); uint32 keys are selected as their int32 bit pattern."""
    cap = shards.shape[1]
    pos = torch.arange(cap, dtype=torch.int32, device=shards.device)
    valid = pos[None, :] < counts.to(torch.int32)[:, None]
    if shards.dtype == torch.uint32:
        return shards.view(torch.int32)[valid].cpu().numpy().view(np.uint32)
    return shards[valid].cpu().numpy()
