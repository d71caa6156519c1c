"""K6: one HSS splitter round's sample of sorted rows, as a compaction.

Row (s, b) of keys (S, B, n) is shard s of request b, sorted ascending
with hi-sentinel pads at its tail. A position is kept when its key lies in
an active interval of request b (lo_key_i < key < hi_key_i for some
unsatisfied i) and its draw u < prob[b]. The round's sample buffer is the
first min(cap, n) kept keys in position order, then the hi sentinel; the
kept count is cut at cap and `overflow` is what the cut dropped. That is
what the reference computes as a membership test of every key, a mask,
and a full sort of the masked row (repro/core/splitters.py:168): a mask
keeps the row's order, so the sorted masked row is the kept keys in
position order, then sentinels.

K6 (`sample_compact`, csrc/sort_kernels.cu) replaces no Pallas kernel: it
replaces that masked sort, which the reference runs through its
sort_blocks and merge sites. What bounds it is bytes: u over the active
positions and the sampled keys, 0.32 ms for a round-1 pass over (8, 2^25)
float32 draws at 3.35 TB/s. Membership needs no key (in a sorted row the
keys of interval i are the index range [first key > lo_key_i, first key
>= hi_key_i)); a block of 8,192 positions builds its membership bitmap
from those ranges and skips u outside them. Two launches a round: the
count launch writes each tile's hits, the emit launch sums the counts
before each tile and writes the kept keys, the counts and the sentinel
tail. No host read.

`sample_compact_plain` computes the same function in torch ops: the index
ranges by `searchsorted` on each row, membership by a difference array
over them, the kept keys placed at their rank among the row's hits (the
tile counts and their prefix sums are a split of that rank).
"""
from __future__ import annotations

import torch

from repro_torch.core.common import hi_sentinel
from repro_torch.kernels import cuda

#: Positions a K6 block owns (kSampleThreads * 32): the size of the count
#: launch's tile-count rows.
TILE = 8192
#: Draw dtypes: the seeded generator's float32, injected float64.
DRAWS = (torch.float32, torch.float64)


def _check_args(keys, lo_key, hi_key, satisfied, u, prob, cap):
    what = "sample_compact"
    cuda.check_keys(keys, what)
    if keys.dim() != 3:
        raise ValueError(f"{what}: expected (shards, batch, n) keys, got "
                         f"{tuple(keys.shape)}")
    shards, batch, n = keys.shape
    if lo_key.dim() != 2 or lo_key.shape[0] != batch:
        raise ValueError(f"{what}: the state must be (batch, m) = ({batch}, "
                         f"m), got {tuple(lo_key.shape)}")
    state = lo_key.shape
    for name, t, dtype in (("lo_key", lo_key, keys.dtype),
                           ("hi_key", hi_key, keys.dtype),
                           ("satisfied", satisfied, torch.bool)):
        if t.dtype != dtype or t.shape != state:
            raise TypeError(f"{what}: {name} must be {dtype} of shape "
                            f"{tuple(state)}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if u.dtype not in DRAWS:
        raise TypeError(f"{what}: draws must be float32 or float64, got "
                        f"{u.dtype}")
    if tuple(u.shape) not in ((shards, n), (shards, batch, n)):
        raise ValueError(f"{what}: draws must be ({shards}, {n}) or "
                         f"({shards}, {batch}, {n}), got {tuple(u.shape)}")
    if prob.dtype != torch.float32 or tuple(prob.shape) != (batch,):
        raise TypeError(f"{what}: prob must be float32 of shape ({batch},), "
                        f"got {prob.dtype} {tuple(prob.shape)}")
    if cap < 1:
        raise ValueError(f"{what}: cap {cap} must be >= 1")
    args = (lo_key, hi_key, satisfied, u, prob)
    if any(t.device != keys.device for t in args):
        raise ValueError(f"{what}: every input must be on {keys.device}")
    if keys.device.type == "cuda" and not all(
            t.is_contiguous() for t in (keys,) + args):
        raise ValueError(f"{what}: CUDA inputs must be contiguous")


def sample_compact_plain(keys, lo_key, hi_key, satisfied, u, prob, cap):
    """K6's plain version; the arguments and results of `sample_compact`."""
    shards, batch, n = keys.shape
    m = lo_key.shape[-1]
    rows = keys.reshape(-1, n)
    per_row = [t.expand(shards, batch, m).reshape(-1, m).contiguous()
               for t in (lo_key, hi_key, satisfied)]
    start = torch.searchsorted(rows, per_row[0], side="right")
    end = torch.searchsorted(rows, per_row[1], side="left")
    live = (~per_row[2] & (start < end)).to(torch.int32)
    delta = torch.zeros((rows.shape[0], n + 1), dtype=torch.int32,
                        device=keys.device)
    delta.scatter_add_(1, start, live)
    delta.scatter_add_(1, end, -live)
    member = (torch.cumsum(delta[:, :n], 1) > 0).reshape(keys.shape)
    draws = u if u.dim() == 3 else u[:, None, :]
    hit = member & (draws < prob[:, None])
    n_hit = hit.sum(dim=-1, dtype=torch.int32)
    out_len = min(cap, n)
    at = torch.cumsum(hit, -1) - 1
    at = torch.where(hit & (at < out_len), at, out_len)
    vals = torch.full((shards, batch, out_len + 1), hi_sentinel(keys.dtype),
                      dtype=keys.dtype, device=keys.device)
    vals.scatter_(-1, at, keys)
    overflow = torch.clamp(n_hit - cap, min=0)
    return vals[..., :out_len], n_hit - overflow, overflow


def sample_compact(keys: torch.Tensor, lo_key: torch.Tensor,
                   hi_key: torch.Tensor, satisfied: torch.Tensor,
                   u: torch.Tensor, prob: torch.Tensor, cap: int):
    """K6: keys (S, B, n) int32 or int64, each row sorted ascending with
    hi-sentinel pads; the state lo_key, hi_key (B, m) of the keys' dtype
    and satisfied (B, m) bool, request b's for all its shards; draws u
    (S, n), shared by a shard's B requests, or (S, B, n), float32 or
    float64; prob (B,) float32 -> (vals (S, B, min(cap, n)), sampled
    (S, B) int32, overflow (S, B) int32): the first min(cap, n) keys with
    lo_key_i < key < hi_key_i for an unsatisfied i and u < prob, in
    position order, then the hi sentinel; sampled their count cut at cap,
    overflow the rest."""
    _check_args(keys, lo_key, hi_key, satisfied, u, prob, cap)
    if keys.device.type == "cpu":
        return sample_compact_plain(keys, lo_key, hi_key, satisfied, u,
                                    prob, cap)
    shards, batch, n = keys.shape
    out_len = min(cap, n)
    dev = keys.device
    vals = torch.empty((shards, batch, out_len), dtype=keys.dtype,
                       device=dev)
    if n == 0 or not shards or not batch:
        zero = torch.zeros((shards, batch), dtype=torch.int32, device=dev)
        return vals, zero, zero.clone()
    sampled = torch.empty((shards, batch), dtype=torch.int32, device=dev)
    overflow = torch.empty_like(sampled)
    rows, m = shards * batch, lo_key.shape[1]
    tile_counts = torch.empty((rows, -(-n // TILE)), dtype=torch.int32,
                              device=dev)
    common = (keys.dtype, keys.data_ptr(), lo_key.data_ptr(),
              hi_key.data_ptr(), satisfied.data_ptr(), u.data_ptr(),
              int(u.dtype == torch.float64), int(u.dim() == 2),
              prob.data_ptr(), tile_counts.data_ptr())
    cuda.launch("sample_compact_count", *common, rows, batch, n, m)
    cuda.launch("sample_compact_emit", *common, vals.data_ptr(),
                sampled.data_ptr(), overflow.data_ptr(), rows, batch, n, m,
                out_len, cap)
    return vals, sampled, overflow
