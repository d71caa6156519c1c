"""Semisort, group-by aggregation and top-k on the partitioner substrate
(counterpart of repro.sort.semisort; DESIGN.md Sec. 10).

Grouping workloads need equal keys contiguous, not a total order, and
that admits cheaper plans than a full sort:

  semisort(keys)            heavy/light separation: heavy hitters, found
                            from a gathered regular sample of the sorted
                            shards, are never exchanged; their exact
                            counts come from one psum and they are
                            reported as (key, count) groups. Only the
                            light keys ride the splitter histogram path
                            (`Partitioner.partition_sorted_batched`, the
                            relaxed seam: caller-owned local sort and a
                            per-row n_valid).
  groupby_aggregate(...)    sum | count | mean | max per distinct key.
                            "count" rides the keys-only semisort; the
                            value aggregates ride the stable `sort_kv`.
  top_k(keys, k)            pruning before any exchange: each shard keeps
                            its top c = min(n_local, round_up(k, 8)) keys
                            (a key below a shard's local (n_local - c)-th
                            rank cannot be in the global top k <= c), and
                            one all_gather of p*c keys and one merge
                            replace the exchange of all N.

Keys whose encoding is the hi sentinel (dtype max, or a float NaN payload
mapping onto it) cannot ride the untagged semisort, whose pads and
buffers are that sentinel: `make_plan` refuses them under tag=False and
`semisort` falls back to the tagged full sort, as `sort()` does; a sorted
output is a valid semisort. `top_k` pads with the LO sentinel instead,
so dtype-max keys are ordinary (winning) keys there.

The local sorts, the probe ranks and the merges go through
`repro_torch.kernels.dispatch`, so under "auto" on the card they launch
the kernels of the sort paths. `uniform` injects the sampling draws as in
`repro_torch.sort.sort`; the light partition draws as `sort` does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.contracts import CommsContract, register_contract
from repro_torch.core.common import hi_sentinel, round_up
from repro_torch.core.splitters import heavy_candidates
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm
from repro_torch.sort import driver
from repro_torch.sort.adapters import as_keys, from_core, make_plan, to_core
from repro_torch.runtime import chaos
from repro_torch.runtime.syncs import sync_site, to_device
from repro_torch.sort.api import (
    _as_spec, _cache_key, _mesh_fingerprint, _sort_batched_impl, _sort_one,
    _with_policies, resolve_device, sort_kv)
from repro_torch.sort.partitioners import (
    Partitioner, ShardCtx, get_partitioner)
from repro_torch.sort.spec import SortSpec

GROUPBY_OPS = ("sum", "count", "mean", "max")


class SemisortStats(NamedTuple):
    """The heavy hitters riding the driver's stats slot."""

    splitter: object       # the light partition's SplitterStats
    heavy_keys: object     # (B, max_heavy) encoded candidates, padded
    heavy_counts: object   # (B, max_heavy) exact counts (0 = pad slot)


def _host(t) -> np.ndarray:
    """A tensor on the host as NumPy (uint32 through its int32 bits)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    with sync_site("semisort.host"):
        t = t.cpu()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


class SemisortOutput:
    """Result of keys-only `semisort`.

    light        SortOutput of the light keys (sorted, which the relaxed
                 contract permits).
    heavy_keys   (H,) distinct heavy keys, ascending, the input's dtype.
    heavy_counts (H,) their exact counts (> 0), int32.
    n            real input key count.

    `gather()` returns all n keys with equal keys contiguous: the heavy
    groups first (ascending), then the sorted lights. A heavy key never
    also appears among the lights. heavy_keys and heavy_counts stay on the
    device until first read; then one copy and the pad filtering run.
    """

    def __init__(self, light, heavy_keys, heavy_counts, n):
        self.light = light
        self._heavy_keys = heavy_keys
        self._heavy_counts = heavy_counts
        self._decode = None
        self.n = n

    @classmethod
    def deferred(cls, light, raw_keys, raw_counts, n, decode):
        """Wrap heavy stats still on the device; `decode` maps encoded
        keys to the caller's dtype when they are first read."""
        out = cls(light, raw_keys, raw_counts, n)
        out._decode = decode
        return out

    def _materialize(self):
        if self._decode is not None:
            hk = _host(self._decode(self._heavy_keys))
            hc = _host(self._heavy_counts)
            keep = hc > 0
            self._heavy_keys, self._heavy_counts = hk[keep], hc[keep]
            self._decode = None

    @property
    def heavy_keys(self):
        self._materialize()
        return self._heavy_keys

    @property
    def heavy_counts(self):
        self._materialize()
        return self._heavy_counts

    @property
    def overflow(self):
        return self.light.overflow

    def heavy_total(self) -> int:
        return int(np.sum(self.heavy_counts, dtype=np.int64))

    def gather(self) -> np.ndarray:
        parts = []
        if self.heavy_keys.size:
            parts.append(np.repeat(self.heavy_keys, self.heavy_counts))
        parts.append(np.asarray(self.light.gather()))
        return np.concatenate(parts)

    def groups(self):
        """-> (keys, counts): every distinct key with its count, keys
        ascending. Raises if the light exchange dropped keys (heavy counts
        are exact by construction)."""
        lk = np.asarray(self.light.gather())
        if lk.shape[0] + self.heavy_total() != self.n:
            raise RuntimeError(
                f"semisort: exchange dropped "
                f"{self.n - lk.shape[0] - self.heavy_total()} light keys "
                "(capacity overflow): raise out_slack/eps, use "
                "on_overflow='retry', or exchange='allgather'")
        lu, lc = np.unique(lk, return_counts=True)
        keys = np.concatenate([self.heavy_keys, lu])
        counts = np.concatenate([np.asarray(self.heavy_counts, np.int64),
                                 lc.astype(np.int64)])
        order = np.argsort(keys, kind="stable")
        return keys[order], counts[order]


class BatchedSemisortOutput:
    """B independent keys-only semisorts in one pipeline. heavy_keys and
    heavy_counts keep the full (B, max_heavy) candidate buffers (copied to
    the host on first read); `request(b)` narrows to one request and
    drops its empty (count 0) slots."""

    def __init__(self, light, heavy_keys, heavy_counts, n):
        self.light = light
        self._heavy_keys = heavy_keys
        self._heavy_counts = heavy_counts
        self._decode = None
        self.n = n

    @classmethod
    def deferred(cls, light, raw_keys, raw_counts, n, decode):
        out = cls(light, raw_keys, raw_counts, n)
        out._decode = decode
        return out

    def _materialize(self):
        if self._decode is not None:
            self._heavy_keys = _host(self._decode(self._heavy_keys))
            self._heavy_counts = _host(self._heavy_counts)
            self._decode = None

    @property
    def heavy_keys(self):
        self._materialize()
        return self._heavy_keys

    @property
    def heavy_counts(self):
        self._materialize()
        return self._heavy_counts

    @property
    def batch(self) -> int:
        return self._heavy_keys.shape[0]   # shape only: no copy

    def request(self, b: int) -> SemisortOutput:
        hk, hc = self.heavy_keys[b], self.heavy_counts[b]
        keep = hc > 0
        return SemisortOutput(self.light.request(b), hk[keep], hc[keep],
                              self.n)

    def gather(self, b: int) -> np.ndarray:
        return self.request(b).gather()


def _heavy_sizing(spec: SortSpec, n_local: int, p: int):
    """Static heavy-detection sizes (semisort.py:213-233). A key of count
    f lands about f * s_loc / n_local hits in the gathered regular sample
    of the sorted shards (to within one a shard), so the threshold f >=
    heavy_fraction * N / p maps onto about heavy_fraction * s_tot / p
    hits, halved so that the discretisation cannot miss a heavy key. A
    false positive costs one (max_heavy,) slot; its exact count keeps it
    right. `out_extra` gives the light exchange room for an undetected
    class just under the threshold, which no splitter can cut: two
    boundary runs a destination."""
    s_loc = spec.semisort_sample or max(64, 8 * p)
    s_loc = max(1, min(int(s_loc), n_local))
    s_tot = p * s_loc
    min_count = max(1, int(spec.heavy_fraction * s_tot / (2 * p)))
    max_heavy = round_up(min(s_tot, max(8, s_tot // min_count)), 8)
    out_extra = int(2.0 * spec.heavy_fraction * n_local) + 8
    return s_loc, min_count, max_heavy, out_extra


def _semisort_shard_fn(part, spec: SortSpec, n_local: int, s_loc: int,
                       min_count: int, max_heavy: int, ex_cfg,
                       fallback: bool):
    """The shard pipeline of `driver.run_batched` (semisort.py:236-307):
    local sort -> heavy detection (the all_gathered regular sample ->
    `heavy_candidates` -> exact counts, one psum) -> heavies masked to the
    sentinel -> the light partition. A `fallback` partitioner
    (multistage) owns its whole pipeline and takes no n_valid, so its
    sentinel tail travels as real maximum keys and the valid count is cut
    at the first sentinel."""
    policy = spec.kernel_policy
    samp_idx = torch.as_tensor((np.arange(s_loc) * n_local) // s_loc)

    def heavy_split(ls, comm):
        p, batch, _ = ls.shape
        sent = hi_sentinel(ls.dtype)
        samp = ls[..., to_device(samp_idx, torch.int64, ls.device)]
        g = comm.all_gather(samp)
        pooled = torch.sort(g.transpose(0, 1).reshape(batch, p * s_loc),
                            dim=-1).values
        hkeys = heavy_candidates(pooled, max_heavy=max_heavy,
                                 min_count=min_count)         # (B, H)
        hk = hkeys.expand(p, *hkeys.shape).contiguous()       # (p, B, H)
        llo = torch.searchsorted(ls, hk, side="left")
        lhi = torch.searchsorted(ls, hk, side="right")
        pos = torch.clamp(torch.searchsorted(hk, ls, side="left"),
                          max=hk.shape[-1] - 1)
        member = torch.gather(hk, -1, pos) == ls
        del pos
        cnt = torch.where(hk == sent, 0, lhi - llo).to(torch.int32)
        hcnt = comm.psum(cnt)                                  # (B, H)
        is_heavy = member & (ls != sent)
        lights = dispatch.local_sort(torch.where(is_heavy, sent, ls),
                                     policy=policy)
        n_sent = (ls == sent).sum(dim=-1, dtype=torch.int32)
        n_light = (n_local - n_sent
                   - is_heavy.sum(dim=-1, dtype=torch.int32))  # (p, B)
        return hkeys, hcnt, lights, n_light

    def shard_fn(local, comm, draws):
        ls = dispatch.local_sort(local, policy=policy)
        hkeys, hcnt, lights, n_light = heavy_split(ls, comm)
        del ls
        ctx = ShardCtx(spec=spec, comm=comm, uniform=draws)
        if fallback:
            out, n_out, keys, ranks, ovf, sstats = part.sharded_batched(
                lights, ctx)
            sent = torch.full(out.shape[:-1] + (1,),
                              hi_sentinel(out.dtype), dtype=out.dtype,
                              device=out.device)
            cut = torch.searchsorted(out, sent, side="left")[..., 0]
            n_out = torch.minimum(n_out.to(torch.int32),
                                  cut.to(torch.int32))
        else:
            out, n_out, keys, ranks, ovf, sstats = \
                part.partition_sorted_batched(lights, ctx, n_valid=n_light,
                                              ex_cfg=ex_cfg)
        return out, n_out, keys, ranks, ovf, SemisortStats(sstats, hkeys,
                                                           hcnt)

    return shard_fn


def _semisort_fast(xs: torch.Tensor, spec: SortSpec, uniform,
                   batched: bool):
    """The keys-only heavy/light semisort of (B, n) keys. `spec` comes
    with tag=False, so `make_plan` raises on sentinel-valued keys (the
    caller then falls back to the tagged sort) and never pays duplicate
    detection."""
    part = get_partitioner(spec.algorithm)
    p = spec.shards
    plan = make_plan(xs, spec, p)
    enc = plan.encode(xs)
    n_local = (plan.n + plan.n_pad) // p
    s_loc, min_count, max_heavy, out_extra = _heavy_sizing(spec, n_local, p)
    ex_cfg = dataclasses.replace(spec.exchange_config(), out_extra=out_extra)
    fallback = type(part).sharded_batched is not Partitioner.sharded_batched
    base = _cache_key(spec, enc, flip=plan.flipped_words)
    cache_key = (None if base is None
                 else ("semisort", s_loc, min_count, max_heavy, out_extra)
                 + base)
    shard_fn = driver.shard_program(
        cache_key, lambda: _semisort_shard_fn(
            part, spec, n_local, s_loc, min_count, max_heavy, ex_cfg,
            fallback), p)
    raw = driver.run_batched(
        shard_fn, enc, p=p, seed=spec.seed, n_real=plan.n,
        local_sort_fn=dispatch.local_sort_fn(spec.kernel_policy),
        uniform=uniform)
    light = plan.decode_batched(raw)
    stats = raw[5]
    if isinstance(stats, SemisortStats):
        # the heavy stats stay on the device until first read
        hk, hc = stats.heavy_keys, stats.heavy_counts
        decode = functools.partial(from_core, dtype=plan.out_dtype)
        if batched:
            return BatchedSemisortOutput.deferred(light, hk, hc, plan.n,
                                                  decode)
        one = light.request(0)
        one.stats = SemisortStats(
            type(stats.splitter)(*(f[..., 0] for f in stats.splitter)),
            hk[0], hc[0])
        return SemisortOutput.deferred(one, hk[0], hc[0], plan.n, decode)
    # p == 1: a full sort, nothing was split
    dtype = _host(xs[..., :0]).dtype
    if batched:
        return BatchedSemisortOutput(
            light, np.zeros((xs.shape[0], 0), dtype),
            np.zeros((xs.shape[0], 0), np.int32), plan.n)
    return SemisortOutput(light.request(0), np.zeros((0,), dtype),
                          np.zeros((0,), np.int32), plan.n)


def _semisort_tagged(xs: torch.Tensor, spec: SortSpec, uniform,
                     batched: bool):
    """The sentinel-collision fallback: the tagged full sort (`sort()`'s
    route for dtype-max keys); a sorted output is a valid semisort with an
    empty heavy set."""
    tag_spec = dataclasses.replace(spec, tag=True)
    dtype = _host(xs[..., :0]).dtype
    if batched:
        out = _with_policies(
            lambda s: _sort_batched_impl(xs, s, uniform), tag_spec,
            batched=True)
        b = xs.shape[0]
        return BatchedSemisortOutput(out, np.zeros((b, 0), dtype),
                                     np.zeros((b, 0), np.int32), out.n)
    x = xs[0]
    out = _with_policies(
        lambda s: _sort_one(x, s, uniform, want_indices=False), tag_spec)
    return SemisortOutput(out, np.zeros((0,), dtype),
                          np.zeros((0,), np.int32), out.n)


def semisort(keys, values=None, spec: SortSpec | None = None, *,
             uniform=None, **overrides):
    """Group equal keys contiguously over the shards (the light path
    delivers a total order anyway).

    Keys only: returns a SemisortOutput, heavy hitters as exact (key,
    count) groups that never touched the exchange and the light keys
    partitioned by the splitter histogram path. With `values` the grouping
    must carry a payload, which takes the tagged stable pipeline: returns
    (grouped_keys, grouped_values) NumPy arrays, as `sort_kv`. `stable`
    and `tag` are ignored on the keys-only path. `uniform` is as in
    `repro_torch.sort.sort`."""
    spec = _as_spec(spec, overrides)
    if values is not None:
        return sort_kv(keys, values, spec, uniform=uniform)
    x = as_keys(keys, resolve_device(spec.device))
    if x.dim() != 1:
        raise ValueError(
            f"semisort expects a 1-D key array, got {tuple(x.shape)}")
    fast = dataclasses.replace(spec, tag=False, stable=False)
    try:
        return _semisort_fast(x[None], fast, uniform, batched=False)
    except ValueError:
        return _semisort_tagged(x[None], spec, uniform, batched=False)


def semisort_batched(xs, spec: SortSpec | None = None, *, uniform=None,
                     **overrides):
    """B independent keys-only semisorts of a (B, n) array in one
    pipeline: one all_gather for heavy detection, one psum for the exact
    counts and the batched light partition; per request the same bits as
    `semisort` of that row (when both plans agree). Returns a
    BatchedSemisortOutput."""
    spec = _as_spec(spec, overrides)
    xs = as_keys(xs, resolve_device(spec.device))
    if xs.dim() != 2:
        raise ValueError(f"semisort_batched expects a (B, n) key array, "
                         f"got {tuple(xs.shape)}")
    fast = dataclasses.replace(spec, tag=False, stable=False)
    try:
        return _semisort_fast(xs, fast, uniform, batched=True)
    except ValueError:
        return _semisort_tagged(xs, spec, uniform, batched=True)


def groupby_aggregate(keys, values=None, op: str = "sum",
                      spec: SortSpec | None = None, *, uniform=None,
                      **overrides):
    """Aggregate `values` per distinct key -> (uniq_keys, aggregates),
    NumPy, keys ascending.

    op="count" needs no values and rides the keys-only semisort (heavy
    counts come off the device psum, light counts from one np.unique of
    the gathered, exactness-checked lights). sum, mean and max ride the
    stable `sort_kv`; sums and means accumulate in int64 or float64."""
    if op not in GROUPBY_OPS:
        raise ValueError(f"op must be one of {GROUPBY_OPS}, got {op!r}")
    spec = _as_spec(spec, overrides)
    if op == "count":
        return semisort(keys, spec=spec, uniform=uniform).groups()
    if values is None:
        raise ValueError(f"groupby_aggregate(op={op!r}) requires values")
    sk, sv = sort_kv(keys, values, spec, uniform=uniform)
    uniq, starts = np.unique(sk, return_index=True)
    if op == "max":
        return uniq, np.maximum.reduceat(sv, starts)
    acc = sv.astype(np.float64 if np.issubdtype(sv.dtype, np.floating)
                    else np.int64)
    sums = np.add.reduceat(acc, starts)
    if op == "sum":
        return uniq, sums
    counts = np.diff(np.append(starts, sk.shape[0]))
    return uniq, sums / counts


def topk_program(rows: torch.Tensor, comm: Comm, c: int, k: int,
                 kernel_policy: str = "auto") -> torch.Tensor:
    """The shard program behind `top_k` (semisort.py:477-503): each shard
    of (p, B, n_local) rows sorts locally and keeps its top-c suffix, ONE
    all_gather of the (p, B, c) suffixes feeds one merge, and the top k
    come out descending, (B, k). No all_to_all; the gather moves p*c keys
    a request where a full sort's exchange moves N."""
    p, batch, n_local = rows.shape
    ls = dispatch.local_sort(rows, policy=kernel_policy)
    g = comm.all_gather(ls[..., n_local - c:])                # (p, B, c)
    merged = dispatch.merge_runs(g.transpose(0, 1), policy=kernel_policy)
    return merged[:, p * c - k:].flip(-1)


# The wire contract of `topk_program` (counterpart of
# repro/sort/semisort.py:510), proved by the analysis lint with
# gather_widths pinned to the concrete c at check time: the pruning claim
# above, stated as counts.
register_contract("top_k", CommsContract(
    name="top_k",
    description="shard-local pruning: ZERO all_to_all, exactly ONE "
                "all_gather of the (c,) pruned suffix per shard",
    total_counts={"all_to_all": 0, "all_gather": 1, "psum": 0,
                  "ppermute": 0},
    batch_invariant=("all_gather", "all_to_all", "psum", "ppermute")))


def _topk_impl(enc: torch.Tensor, k: int, spec: SortSpec) -> torch.Tensor:
    """Top k of each row of (B, n) encoded keys -> (B, k) descending."""
    p = spec.shards
    n = enc.shape[-1]
    if p == 1:
        return torch.sort(enc, dim=-1).values[:, n - k:].flip(-1)
    # LO pads sort to the front of each row: the top-k suffix is safe
    enc, _ = driver.pad_to_shards_lo(enc, p)
    batch, n_local = enc.shape[0], enc.shape[1] // p
    rows = enc.reshape(batch, p, n_local).transpose(0, 1).contiguous()
    c = min(n_local, round_up(k, 8))
    # semisort.py:539-545; the unbatched top_k is B = 1 here, so it shares
    # the batched line of its shape
    cache_key = ("topk", batch, k, c, n_local, str(enc.dtype),
                 spec.kernel_policy, _mesh_fingerprint(spec),
                 chaos.trace_token())
    driver.exec_cache.lookup(cache_key)
    return topk_program(rows, Comm(p), c=c, k=k,
                        kernel_policy=spec.kernel_policy)


def _top_k_rows(xs: torch.Tensor, k: int, spec: SortSpec) -> np.ndarray:
    n = xs.shape[1]
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    top = _topk_impl(to_core(xs), k, spec)
    return _host(from_core(top, xs.dtype))


def top_k(keys, k: int, spec: SortSpec | None = None, **overrides):
    """The k largest keys, descending, as a (k,) NumPy array. Never runs a
    full sort (`topk_program`). Exact for every dtype the sort front door
    takes; dtype-max keys are fine (the pads are LO sentinels, and a pad
    equal to a real dtype-min key is the same value)."""
    spec = _as_spec(spec, overrides)
    x = as_keys(keys, resolve_device(spec.device))
    if x.dim() != 1:
        raise ValueError(
            f"top_k expects a 1-D key array, got {tuple(x.shape)}")
    return _top_k_rows(x[None], k, spec)[0]


def top_k_batched(xs, k: int, spec: SortSpec | None = None, **overrides):
    """Per-row top k of a (B, n) batch in one pipeline -> (B, k) NumPy,
    each row descending; the same bits per row as `top_k`."""
    spec = _as_spec(spec, overrides)
    xs = as_keys(xs, resolve_device(spec.device))
    if xs.dim() != 2:
        raise ValueError(
            f"top_k_batched expects (B, n), got {tuple(xs.shape)}")
    return _top_k_rows(xs, k, spec)
