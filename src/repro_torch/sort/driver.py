"""The host-level sort driver (counterpart of repro.sort.driver).

`run_batched` sorts B equal-length requests in one pipeline (counterpart
of driver.py:315-383; an unbatched sort is B = 1). It pads each request to
a multiple of p with the hi sentinel, lays it out as shard rows, builds
the collective seam and the sampling draws, runs the shard-level
`sort_fn`, and strips the pads back out of the counts. The reference
compiles the shard program once per shape and keeps it in an executable
cache; eager PyTorch has no trace to cache, and the cache's hit-rate
counters come with the serving slice (ROADMAP queue 1 item 7).

Shard s of request b holds columns s*n_local .. (s+1)*n_local of row b,
as in the reference, so request b lands on the same shards as an
unbatched sort of row b. The rows `sort_fn` gets keep the shard axis
leading, (p, B, n_local), so `Comm` is unchanged and the kernels see p*B
rows; the result comes back in the reference's layout, (B, p, ...).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.common import hi_sentinel, lo_sentinel
from repro_torch.parallel.comm import Comm


def pad_to_shards(x: torch.Tensor, p: int):
    """Sentinel-pad the last axis of x up to a multiple of p. Returns
    (padded, n_pad)."""
    n_pad = (-x.shape[-1]) % p
    if n_pad == 0:
        return x, 0
    pad = torch.full(x.shape[:-1] + (n_pad,), hi_sentinel(x.dtype),
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=-1), n_pad


def pad_to_shards_lo(x: torch.Tensor, p: int):
    """The lo-sentinel counterpart of `pad_to_shards` for max-seeking paths
    (repro_torch.sort.semisort.top_k): pads go in FRONT of the last axis
    as the smallest value, so they never displace a real key from the top
    of the order (driver.py:205-216). Returns (padded, n_pad)."""
    n_pad = (-x.shape[-1]) % p
    if n_pad == 0:
        return x, 0
    pad = torch.full(x.shape[:-1] + (n_pad,), lo_sentinel(x.dtype),
                     dtype=x.dtype, device=x.device)
    return torch.cat([pad, x], dim=-1), n_pad


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
    shards (..., p, cap), counts (..., p), n_restore (...): leading axes
    are independent requests.
    """
    cap = shards.shape[-1]
    pos = torch.arange(cap, dtype=torch.int32, device=shards.device)
    valid = pos < counts[..., None]
    pads = valid & (shards == hi_sentinel(shards.dtype))
    stripped = pads.sum(dim=-1, dtype=torch.int32)
    counts = counts - stripped
    if n_restore is None:
        return counts
    keep = torch.clamp(stripped.sum(dim=-1, dtype=torch.int32) - n_pad,
                       min=0)
    keep = torch.minimum(keep, n_restore)[..., None]
    before = torch.cumsum(stripped, -1, dtype=torch.int32) - stripped
    restored = torch.clamp(torch.maximum(keep - before,
                                         torch.zeros_like(before)),
                           max=stripped)
    return counts + restored


def factor_stages(p: int) -> tuple[int, int]:
    """(r1, r2) with r1*r2 == p and r1 the largest divisor <= sqrt(p): the
    default (outer, inner) grid of multistage (driver.py:178-184)."""
    r1 = 1
    for d in range(1, math.isqrt(p) + 1):
        if p % d == 0:
            r1 = d
    return r1, p // r1


def default_uniform(p: int, seed: int, device):
    """(j, n) -> (p, n) float32 U[0, 1) draws from one seeded
    `torch.Generator` on `device` (each call draws the next block)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return lambda j, n: torch.rand((p, n), generator=gen, device=device)


def run_batched(sort_fn, xs: torch.Tensor, *, p: int, seed: int = 0,
                n_real: int | None = None, local_sort_fn=None, uniform=None):
    """Run B independent shard-level sorts over p emulated shards in one
    pipeline. xs is (B, n): B equal-length requests.

    `sort_fn(rows, comm, uniform)` gets the (p, B, n_local) shard rows and
    returns ((p, B, cap), (p, B), keys (B, p-1), ranks (B, p-1), overflow
    (B,), stats): a `Partitioner.sharded_batched`. Returns the raw batched
    tuple (shards (B, p, cap), counts (B, p), keys, ranks, overflow,
    stats). `local_sort_fn` is the (B, n) -> (B, n) sort of the p == 1
    short-circuit, whose counts are `n_real` (default n). `uniform` ((j,
    n) -> (p, n) float32 array: draw j, n per shard; row s is shard s =
    outer*r2 + inner on multistage's grid, as driver.py:290-292 numbers
    it) overrides the seeded draws, shared by every request; tests inject
    the reference's own. Each algorithm numbers its draws (see its
    partitioner).
    """
    dev = xs.device
    batch, n = xs.shape
    n_real = n if n_real is None else n_real
    if p == 1:
        sort_rows = local_sort_fn or (lambda v: torch.sort(v, dim=-1).values)
        out = sort_rows(xs)
        return (out[:, None, :],
                torch.full((batch, 1), n_real, dtype=torch.int32, device=dev),
                torch.zeros((batch, 0), dtype=xs.dtype, device=dev),
                torch.zeros((batch, 0), dtype=torch.int32, device=dev),
                torch.zeros((batch,), dtype=torch.int32, device=dev), None)
    n_sent_real = None
    if n % p:   # per-request sentinel-valued data keys, counted pre-pad
        n_sent_real = (xs == hi_sentinel(xs.dtype)).sum(dim=1,
                                                        dtype=torch.int32)
    xs, n_pad = pad_to_shards(xs, p)
    n_local = xs.shape[1] // p
    rows = xs.reshape(batch, p, n_local).transpose(0, 1).contiguous()
    out, counts, keys, ranks, ovf, stats = sort_fn(
        rows, Comm(p), _draws(uniform, p, seed, dev))
    out = out.transpose(0, 1).contiguous()
    counts = counts.transpose(0, 1).contiguous()
    if n_pad:   # our sentinel pads may have been counted as keys
        counts = strip_sentinel_counts(out, counts, n_pad=n_pad,
                                       n_restore=n_sent_real)
    return out, counts, keys, ranks, ovf, stats


def _draws(uniform, p: int, seed: int, device):
    """The (j, n) -> (p, n) draws: the seeded generator, or the injected
    source moved onto the device. Injected draws keep a float64 dtype (the
    reference's under jax x64), so that `u < prob` compares as the
    reference's does."""
    if uniform is None:
        return default_uniform(p, seed, device)

    def draws(j, n):
        u = torch.as_tensor(uniform(j, n), device=device)
        if tuple(u.shape) != (p, n):
            raise ValueError(f"injected draws {j}: shape {tuple(u.shape)}, "
                             f"want {(p, n)}")
        return u if u.dtype == torch.float64 else u.to(torch.float32)
    return draws


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
