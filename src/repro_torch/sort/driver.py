"""The host-level sort driver (counterpart of repro.sort.driver).

`run_batched` sorts B equal-length requests in one pipeline (counterpart
of driver.py:315-383; an unbatched sort is B = 1). It pads each request to
a multiple of p with the hi sentinel, lays it out as shard rows, builds
the collective seam and the sampling draws, runs the shard-level
`sort_fn`, and strips the pads back out of the counts. The front doors
build that shard program through `shard_program`, which records each
launch in `exec_cache` under the key the reference caches its compiled
executable under (driver.py:54-139), so that the serving layer counts
hits per batch as the reference's does.

Shard s of request b holds columns s*n_local .. (s+1)*n_local of row b,
as in the reference, so request b lands on the same shards as an
unbatched sort of row b. The rows `sort_fn` gets keep the shard axis
leading, (p, B, n_local), so `Comm` is unchanged and the kernels see p*B
rows; the result comes back in the reference's layout, (B, p, ...).
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.common import hi_sentinel, lo_sentinel
from repro_torch.parallel.comm import Comm
from repro_torch.runtime.syncs import sync_site, to_device


class ExecutableCache:
    """The cache accounting of the sort front doors (counterpart of
    repro/sort/driver.py:54-136, DESIGN.md Sec. 6.3).

    The reference caches a jitted callable, so that a warm request skips
    tracing and compiling. Eager PyTorch compiles nothing, and building a
    launch's shard program (the partitioner, the kernel policy's local
    sort, the audit wrapper, the closure `run_batched` calls) takes a few
    microseconds of host time. So this cache stores no program: it records
    the keys the reference would cache under (shape bucket, dtype, the
    SortSpec fingerprint, the shard count and device; see
    repro_torch.sort.api), every launch builds its program anew, and a hit
    saves nothing. What the keys give is the reference's accounting (hits,
    misses, evictions, LRU order), which the serving metrics read per
    bucket. No CUDA graph is captured either: HSS reads its early exit on
    the host once a round, and the retry policy its overflow once a
    launch, so a graph could not hold a round.

    `get_or_build(key, build)` records one launch under `key` and returns
    `build()`. Key None (warm-start probes, an injected corruption: what
    the reference leaves uncached) records nothing. `traces` counts the
    launches the reference would trace, a miss or an uncached launch
    (`shard_program`), as the reference counts trace-time executions of
    the shard body.

    Eviction is LRU with a capacity cap (`max_entries`): a hit refreshes
    the key, a miss past capacity evicts the least recently used and adds
    one to `evictions`. `stats()` is what the serving metrics read
    (repro_torch.serve.metrics), and the dynamic batcher attributes the
    per-batch deltas to its buckets. The bookkeeping is under a lock: the
    serving dispatch thread and the main thread share the global
    instance.
    """

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._keys: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.traces = 0     # launches the reference would trace

    def lookup(self, key) -> bool:
        """Record one launch under `key`; True on a hit. Key None records
        nothing and is no hit."""
        if key is None:
            return False
        with self._lock:
            if key in self._keys:
                self.hits += 1
                self._keys.move_to_end(key)
                return True
            self.misses += 1
            self._keys[key] = None
            while len(self._keys) > self.max_entries:
                self._keys.popitem(last=False)
                self.evictions += 1
            return False

    def get_or_build(self, key, build):
        self.lookup(key)
        return build()

    def contains(self, key) -> bool:
        """Whether `key` is recorded (no LRU refresh)."""
        with self._lock:
            return key in self._keys

    def count_trace(self) -> None:
        with self._lock:
            self.traces += 1

    def stats(self) -> dict:
        """The counters as a plain dict (safe to diff: the serving layer
        attributes per-batch deltas to its buckets)."""
        with self._lock:
            total = self.hits + self.misses
            return {"size": len(self._keys), "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "traces": self.traces,
                    "hit_rate": self.hits / total if total else 0.0}

    def clear(self):
        with self._lock:
            self._keys.clear()
            self.hits = self.misses = self.evictions = self.traces = 0

    def __len__(self):
        return len(self._keys)


exec_cache = ExecutableCache()


def shard_program(key, build, p: int):
    """The shard program of one launch over p shards, built anew, its
    launch recorded in `exec_cache` under `key` (a miss or key None
    counts in `traces`). p == 1 runs no shard program (`run_batched`
    sorts locally), so it builds nothing and touches no counter, as the
    reference's p == 1 short-circuit returns before its cache
    (driver.py:270-275)."""
    if p == 1:
        return None
    if not exec_cache.lookup(key):
        exec_cache.count_trace()
    return build()


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
        u = torch.as_tensor(uniform(j, n))
        u = to_device(u, u.dtype, device)
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
    with sync_site("gather"):
        if shards.dtype == torch.uint32:
            return (shards.view(torch.int32)[valid].cpu().numpy()
                    .view(np.uint32))
        return shards[valid].cpu().numpy()
