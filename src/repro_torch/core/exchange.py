"""Key redistribution (the data-exchange phase, paper Section 3.1 step 3).

Counterpart of `repro.core.exchange`, two strategies:

  dense      a capacity-padded all_to_all. Each source cuts its sorted
             shard into p destination slices by searchsorted against the
             splitters, sends at most `pair_cap` keys per (source,
             destination) pair, and each destination k-way merges the p
             sorted runs it receives. Keys past a pair's capacity are
             dropped AND counted, so callers can detect it.
  allgather  exact: every shard is gathered, and each destination keeps its
             key-range window of every source run (two searchsorteds per
             run) and merges the p windows.

HSS's balanced splitting guarantees at most (1+eps)*N/p keys per
destination, which is what makes the static `out_cap` sound.

The batched forms take (p, B, n_local) shards and (B, p-1) splitters — the
shard axis leading, so `Comm` moves all B requests in one call per phase
(`BATCH_FUSED_STRATEGIES`) — and every destination's work runs at once.
The unbatched `exchange` is the batched one at B = 1. dense_spill and
ragged come with ROADMAP queue 1 item 8, batched and unbatched alike.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.common import hi_sentinel, pow2_ceil, round_up
from repro_torch.kernels import dispatch
from repro_torch.kernels.merge.ops import cap_to, gather_runs
from repro_torch.parallel.comm import Comm

#: Collectives of one exchange, the same at any B. dense: payload + counts
#: all_to_all, the send-side overflow psum and the receive-side truncation
#: psum; allgather: payload + counts all_gather and the truncation psum.
EXCHANGE_COLLECTIVES = {
    "dense": {"all_to_all": 2, "all_gather": 0, "psum": 2},
    "allgather": {"all_to_all": 0, "all_gather": 2, "psum": 1},
}

#: Batched strategies whose collective count does not grow with B.
BATCH_FUSED_STRATEGIES = ("dense", "allgather")


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    strategy: str = "dense"
    pair_factor: float = 3.0      # per-(src, dst) capacity = factor*n/p
    out_slack: float = 1.0        # extra slack on the (1+eps) output capacity
    capacity_scale: float = 1.0   # multiplier on every static buffer
    kernel_policy: str = "auto"   # post-exchange merge backend (dispatch)

    def pair_cap(self, n_local: int, p: int) -> int:
        base = max(8, int(self.pair_factor * n_local / p))
        return min(n_local,
                   round_up(max(1, int(base * self.capacity_scale)), 8))

    def out_cap(self, n_local: int, p: int, eps: float) -> int:
        return round_up(
            int((1.0 + eps) * self.out_slack * self.capacity_scale * n_local)
            + 8, 8)


def destination_slices(local_sorted: torch.Tensor,
                       splitter_keys: torch.Tensor, n_valid=None):
    """Contiguous [start, end) slice of each sorted row per destination.

    local_sorted (..., n), splitter_keys (p-1,) or with leading axes that
    broadcast against the rows' (right-aligned) -> (starts, counts), each
    (..., p) int32. n_valid (an int or a tensor broadcasting against the
    rows' leading axes) excludes a sentinel-padded tail from the last
    slice."""
    lead, n = local_sorted.shape[:-1], local_sorted.shape[-1]
    dev = local_sorted.device
    keys = splitter_keys.expand(lead + splitter_keys.shape[-1:]).contiguous()
    b = torch.searchsorted(local_sorted, keys, side="left").to(torch.int32)
    nv = torch.as_tensor(n if n_valid is None else n_valid,
                         dtype=torch.int32, device=dev)
    nv = nv.expand(lead)[..., None]
    b = torch.minimum(b, nv)
    zeros = torch.zeros(lead + (1,), dtype=torch.int32, device=dev)
    starts = torch.cat([zeros, b], dim=-1)
    ends = torch.cat([b, nv], dim=-1)
    return starts, ends - starts


def _rows_valid(n_valid, batch: int, n: int, device) -> torch.Tensor:
    """The batched n_valid parameter as a (B,) vector: None means every
    slot is real; a scalar applies to every request; (B,) passes."""
    nv = n if n_valid is None else n_valid
    return torch.as_tensor(nv, dtype=torch.int32,
                           device=device).expand(batch)


def exchange_dense_batched(local_sorted: torch.Tensor,
                           splitter_keys: torch.Tensor, *, comm: Comm,
                           cfg: ExchangeConfig, eps: float, n_valid=None):
    """local_sorted (p, B, n_local), splitter_keys (B, p-1) -> (out (p, B,
    out_cap) sorted sentinel-padded rows, n_valid (p, B), overflow (B,):
    dropped keys, send and receive side)."""
    p, batch, n = local_sorted.shape
    dev = local_sorted.device
    cap = cfg.pair_cap(n, p)
    out_cap = cfg.out_cap(n, p, eps)
    sent_hi = hi_sentinel(local_sorted.dtype)

    starts, counts = destination_slices(
        local_sorted, splitter_keys,
        _rows_valid(n_valid, batch, n, dev))          # (p_src, B, p_dst)
    sent_counts = torch.minimum(counts, torch.tensor(cap, dtype=torch.int32,
                                                     device=dev))
    overflow = comm.psum((counts - sent_counts).sum(dim=-1,
                                                    dtype=torch.int32))
    # the send buffer in all_to_all's layout (p_src, p_dst, B, cap); its
    # flat gather index into the shards is built once
    starts = starts.permute(0, 2, 1)
    sent_counts = sent_counts.permute(0, 2, 1).contiguous()
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    row = torch.arange(p * batch, dtype=torch.int64,
                       device=dev).reshape(p, 1, batch, 1) * n
    idx = row + torch.clamp(starts.to(torch.int64)[..., None] + pos,
                            max=n - 1)
    vals = local_sorted.reshape(-1)[idx]
    del idx
    buf = torch.where(pos < sent_counts[..., None], vals, sent_hi)
    del vals

    recv = comm.all_to_all(buf)                       # (p_dst, p_src, B, cap)
    recv_counts = comm.all_to_all(sent_counts)        # (p_dst, p_src, B)
    # p sorted sentinel-tailed runs of cap keys per (destination, request)
    merged = dispatch.merge_runs(recv.transpose(1, 2),
                                 policy=cfg.kernel_policy)
    out = cap_to(merged, out_cap)
    n_recv = recv_counts.sum(dim=1, dtype=torch.int32)   # (p_dst, B)
    # Receive-side truncation (only possible when the splitting violated
    # its eps guarantee) is overflow too.
    trunc = torch.clamp(n_recv - out_cap, min=0)
    overflow = overflow + comm.psum(trunc)
    return out, n_recv - trunc, overflow


def exchange_allgather_batched(local_sorted: torch.Tensor,
                               splitter_keys: torch.Tensor, *, comm: Comm,
                               cfg: ExchangeConfig, eps: float,
                               n_valid=None):
    """The exact allgather exchange over (p, B, n_local) shards and (B,
    p-1) splitters; returns as `exchange_dense_batched` (overflow counts
    receive-side truncation only)."""
    p, batch, n = local_sorted.shape
    dev = local_sorted.device
    out_cap = cfg.out_cap(n, p, eps)

    everything = comm.all_gather(local_sorted)                # (p, B, n)
    nv = comm.all_gather(
        _rows_valid(n_valid, batch, n, dev).expand(p, batch))  # (p_src, B)
    # Every destination's key range [lo, hi) at once: a contiguous window
    # of each sorted source run, two searchsorteds per (run, destination).
    me = comm.axis_index(dev)                                 # (p_dst,)
    lo = splitter_keys[:, torch.clamp(me - 1, min=0)]         # (B, p_dst)
    hi = splitter_keys[:, torch.clamp(me, max=p - 2)]
    a = torch.searchsorted(everything, lo.expand(p, batch, p).contiguous(),
                           side="left").to(torch.int32)
    b = torch.searchsorted(everything, hi.expand(p, batch, p).contiguous(),
                           side="left").to(torch.int32)
    a = torch.where(me > 0, a, 0)                 # (p_src, B, p_dst)
    b = torch.where(me < p - 1, b, n)
    ends = torch.minimum(b, nv[..., None])
    starts = torch.minimum(a, ends)
    counts = (ends - starts).permute(2, 1, 0)     # (p_dst, B, p_src)
    n_out = counts.sum(dim=-1, dtype=torch.int32)             # (p_dst, B)

    # Each request's p source runs back to back; every (destination,
    # request) row gathers its p windows at once. slot = n bounds every
    # window; it is rounded up to the merge's power of two here, which
    # only adds sentinels past every window (they sort to the tail and
    # cap_to cuts them), so the cascade does not pad a second copy.
    flat = everything.transpose(0, 1).reshape(batch, p * n)
    src = torch.arange(p, dtype=torch.int32, device=dev) * n
    runs = gather_runs(flat, src + starts.permute(2, 1, 0), counts,
                       pow2_ceil(n))              # (p_dst, B, p_src, slot)
    merged = dispatch.merge_runs(runs, policy=cfg.kernel_policy)
    del runs
    out = cap_to(merged, out_cap)
    trunc = torch.clamp(n_out - out_cap, min=0)
    return out, n_out - trunc, comm.psum(trunc)


_STRATEGIES_BATCHED = {
    "dense": exchange_dense_batched,
    "allgather": exchange_allgather_batched,
}


def exchange_batched(local_sorted: torch.Tensor,
                     splitter_keys: torch.Tensor, *, comm: Comm,
                     cfg: ExchangeConfig | None = None, eps: float = 0.05,
                     n_valid=None):
    """Redistribute B requests at once: local_sorted (p, B, n_local),
    splitter_keys (B, p-1) -> (out (p, B, out_cap), n_valid (p, B),
    overflow (B,)). n_valid may be None, a scalar or a (B,) vector."""
    cfg = cfg or ExchangeConfig()
    fn = _STRATEGIES_BATCHED.get(cfg.strategy)
    if fn is None:
        raise NotImplementedError(
            f"exchange strategy {cfg.strategy!r} is not ported yet "
            "(ROADMAP queue 1 item 8); the port has "
            f"{sorted(_STRATEGIES_BATCHED)}")
    return fn(local_sorted, splitter_keys, comm=comm, cfg=cfg, eps=eps,
              n_valid=n_valid)


def exchange(local_sorted: torch.Tensor, splitter_keys: torch.Tensor, *,
             comm: Comm, cfg: ExchangeConfig | None = None,
             eps: float = 0.05, n_valid=None):
    """Redistribute one sort's (p, n_local) shards by its (p-1,) splitters
    -> (out (p, out_cap), n_valid (p,), overflow scalar): the batched
    strategy at B = 1."""
    out, nv, ovf = exchange_batched(
        local_sorted[:, None], splitter_keys[None], comm=comm, cfg=cfg,
        eps=eps, n_valid=n_valid)
    return out[:, 0], nv[:, 0], ovf[0]
