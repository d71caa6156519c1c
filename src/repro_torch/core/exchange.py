"""Key redistribution (the data-exchange phase, paper Section 3.1 step 3).

Counterpart of `repro.core.exchange`, three strategies:

  dense        a capacity-padded all_to_all. Each source cuts its sorted
               shard into p destination slices by searchsorted against
               the splitters, sends at most `pair_cap` keys per (source,
               destination) pair, and each destination k-way merges the p
               sorted runs it receives. Keys past a pair's capacity are
               dropped AND counted, so callers can detect it.
  dense_spill  the dense channel plus an exact spill channel: the keys a
               pair's capacity would drop are compacted into a side
               buffer, all_gathered, and each destination takes its
               key-range window of every source's spill run and merges
               those p windows with the p dense runs. Only receive-side
               truncation (out_cap) can still drop keys. This is
               `SortSpec(on_overflow="spill")`.
  allgather    exact: every shard is gathered, and each destination keeps
               its key-range window of every source run (two
               searchsorteds per run) and merges the p windows.
  ragged       exact alltoallv: the slice counts and the receive offsets
               go through two all_to_alls, every slice lands back to back
               in its destination's out_cap buffer through one
               `Comm.ragged_all_to_all`, and each destination merges the
               p runs at their offsets (`dispatch.merge_ragged`: a merge
               tree of `ragged_slot` keys a run, or a full sort of the
               buffer when a run exceeds it).

HSS's balanced splitting guarantees at most (1+eps)*N/p keys per
destination, which is what makes the static `out_cap` sound.

The batched forms take (p, B, n_local) shards and (B, p-1) splitters — the
shard axis leading, so `Comm` moves all B requests in one call per phase
(`BATCH_FUSED_STRATEGIES`) — and every destination's work runs at once.
dense_spill's batched form runs one request at a time, as the reference's
does (exchange.py:430), so its collectives grow with B. ragged's batched
form moves all B requests in one call per phase: the reference loops over
requests (exchange.py:415) because the TPU collective takes one chunk per
peer, and the index gather here has no such limit. The unbatched
`exchange` is the batched one at B = 1.

Where the received keys total more than out_cap, ragged cuts them at the
buffer's end and counts the cut as overflow (one psum), as dense counts
its receive-side truncation; the reference leaves that case to the TPU
runtime and reports overflow 0 (ROADMAP queue 3). With no cut, its keys,
counts and zero overflow are the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.common import hi_sentinel, round_up
from repro_torch.kernels import dispatch
from repro_torch.kernels.merge.ops import gather_runs
from repro_torch.parallel.comm import Comm
from repro_torch.runtime import chaos
from repro_torch.runtime.syncs import to_device

#: Collectives of one exchange of one request. dense: payload + counts
#: all_to_all, the send-side overflow psum and the receive-side truncation
#: psum; dense_spill: the dense channel's two all_to_all, the spill
#: buffer's and spill counts' all_gather and the truncation psum;
#: allgather: payload + counts all_gather and the truncation psum; ragged:
#: counts + offsets all_to_all around one ragged_all_to_all, and the
#: truncation psum the reference lacks. The batch-fused strategies make
#: the same calls at any B.
EXCHANGE_COLLECTIVES = {
    "dense": {"all_to_all": 2, "all_gather": 0, "psum": 2},
    "dense_spill": {"all_to_all": 2, "all_gather": 2, "psum": 1},
    "allgather": {"all_to_all": 0, "all_gather": 2, "psum": 1},
    "ragged": {"all_to_all": 2, "all_gather": 0, "ragged_all_to_all": 1,
               "psum": 1},
}

#: Batched strategies whose collective count does not grow with B.
BATCH_FUSED_STRATEGIES = ("dense", "allgather", "ragged")


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    strategy: str = "dense"
    pair_factor: float = 3.0      # per-(src, dst) capacity = factor*n/p
    out_slack: float = 1.0        # extra slack on the (1+eps) output capacity
    capacity_scale: float = 1.0   # multiplier on every static buffer
    kernel_policy: str = "auto"   # send and merge backend (dispatch)
    out_extra: int = 0            # additive output headroom (semisort lights)

    def pair_cap(self, n_local: int, p: int) -> int:
        # The chaos clamp (repro_torch.runtime.chaos) applies to the base
        # capacity and `capacity_scale` after it, so the retry policy's
        # escalation can out-grow an injected clamp (exchange.py:86-93).
        base = chaos.clamp_pair_cap(
            max(8, int(self.pair_factor * n_local / p)))
        return min(n_local,
                   round_up(max(1, int(base * self.capacity_scale)), 8))

    def out_cap(self, n_local: int, p: int, eps: float) -> int:
        # out_extra is additive headroom on the multiplicative slack: the
        # semisort light path's room for a key class just under the heavy
        # threshold, which no splitter can cut
        return round_up(
            int((1.0 + eps) * self.out_slack * self.capacity_scale * n_local)
            + self.out_extra + 8, 8)

    def ragged_slot(self, n_local: int, p: int, eps: float) -> int:
        """The ragged merge tree's static run capacity: twice the balanced
        per-pair load. A longer run (the splitting broke its eps
        guarantee) sends the merge to its full-sort branch."""
        return min(n_local, max(16, int(2.0 * (1.0 + eps) * n_local / p)))


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
    nv = to_device(n if n_valid is None else n_valid, torch.int32, dev)
    nv = nv.expand(lead)[..., None]
    b = torch.minimum(b, nv)
    zeros = torch.zeros(lead + (1,), dtype=torch.int32, device=dev)
    starts = torch.cat([zeros, b], dim=-1)
    ends = torch.cat([b, nv], dim=-1)
    return starts, ends - starts


def _rows_valid(n_valid, p: int, batch: int, n: int,
                device) -> torch.Tensor:
    """The batched n_valid parameter as a (p, B) tensor: None means every
    slot is real; a scalar applies to every row; (B,) gives each request
    one count on every shard; (p, B) gives each (shard, request) row its
    own (multistage's second stage)."""
    nv = n if n_valid is None else n_valid
    return to_device(nv, torch.int32, device).expand(p, batch)


def _dense_send(local_sorted: torch.Tensor, starts: torch.Tensor,
                sent_counts: torch.Tensor, cap: int, comm: Comm,
                policy: str):
    """The dense channel: each (source, request) row sends at most `cap`
    keys of each destination slice, sentinel padded, in one all_to_all of
    the keys and one of the counts. local_sorted (p, B, n), starts and
    sent_counts (p_src, B, p_dst) -> (recv (p_dst, p_src, B, cap),
    recv_counts (p_dst, p_src, B))."""
    buf = dispatch.dense_send(local_sorted, starts, sent_counts, cap,
                              policy=policy)   # (p_src, p_dst, B, cap)
    return (comm.all_to_all(buf),
            comm.all_to_all(sent_counts.permute(0, 2, 1).contiguous()))


def _gather_windows(runs: torch.Tensor, n_valid: torch.Tensor,
                    splitter_keys: torch.Tensor, comm: Comm, slot: int):
    """Every destination's key range [lo, hi) as a contiguous window of
    each gathered sorted run, by two searchsorteds per (run,
    destination): runs (p_src, B, n), n_valid (p_src, B), splitter_keys
    (B, p-1) -> (windows (p_dst, B, p_src, slot) sentinel padded, counts
    (p_dst, B, p_src)). slot must bound every window."""
    p, batch, n = runs.shape
    dev = runs.device
    me = comm.axis_index(dev)                                 # (p_dst,)
    lo = splitter_keys[:, torch.clamp(me - 1, min=0)]         # (B, p_dst)
    hi = splitter_keys[:, torch.clamp(me, max=p - 2)]
    a = torch.searchsorted(runs, lo.expand(p, batch, p).contiguous(),
                           side="left").to(torch.int32)
    b = torch.searchsorted(runs, hi.expand(p, batch, p).contiguous(),
                           side="left").to(torch.int32)
    a = torch.where(me > 0, a, 0)                 # (p_src, B, p_dst)
    b = torch.where(me < p - 1, b, n)
    ends = torch.minimum(b, n_valid[..., None])
    starts = torch.minimum(a, ends).permute(2, 1, 0)
    counts = (ends.permute(2, 1, 0) - starts)     # (p_dst, B, p_src)
    # each request's p source runs back to back; every (destination,
    # request) row gathers its p windows at once
    flat = runs.transpose(0, 1).reshape(batch, p * n)
    src = torch.arange(p, dtype=torch.int32, device=dev) * n
    return gather_runs(flat, src + starts, counts, slot), counts


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

    starts, counts = destination_slices(
        local_sorted, splitter_keys,
        _rows_valid(n_valid, p, batch, n, dev))       # (p_src, B, p_dst)
    sent_counts = torch.clamp(counts, max=cap)
    overflow = comm.psum((counts - sent_counts).sum(dim=-1,
                                                    dtype=torch.int32))
    recv, recv_counts = _dense_send(local_sorted, starts, sent_counts, cap,
                                    comm, cfg.kernel_policy)
    # recv (p_dst, p_src, B, cap)
    # p sorted sentinel-tailed runs of cap keys per (destination, request),
    # each holding its received count's keys
    out = dispatch.merge_runs(recv.transpose(1, 2), policy=cfg.kernel_policy,
                              counts=recv_counts.transpose(1, 2),
                              out_len=out_cap)
    n_recv = recv_counts.sum(dim=1, dtype=torch.int32)   # (p_dst, B)
    # Receive-side truncation (only possible when the splitting violated
    # its eps guarantee) is overflow too.
    trunc = torch.clamp(n_recv - out_cap, min=0)
    overflow = overflow + comm.psum(trunc)
    return out, n_recv - trunc, overflow


def exchange_dense_spill(local_sorted: torch.Tensor,
                         splitter_keys: torch.Tensor, *, comm: Comm,
                         cfg: ExchangeConfig, eps: float, n_valid=None):
    """The dense exchange plus an exact spill channel, for one request:
    local_sorted (p, n_local), splitter_keys (p-1,), n_valid None, a
    scalar or (p,) -> (out (p, out_cap), n_valid (p,), overflow scalar:
    receive-side truncation only).

    The dense channel is `exchange_dense_batched`'s. A key spills when its
    offset in its destination slice is past the pair's capacity; each
    source compacts its spilled keys (a local sort of the masked row keeps
    them sorted), the spill rows and their counts are all_gathered, and
    each destination takes its key-range window of every spill row, as
    the allgather exchange does. The windows land where the dense slices
    would have sent those keys, so the merge of the p dense runs and the p
    windows equals an uncapped dense exchange."""
    p, n = local_sorted.shape
    dev = local_sorted.device
    cap = cfg.pair_cap(n, p)
    out_cap = cfg.out_cap(n, p, eps)
    sent_hi = hi_sentinel(local_sorted.dtype)
    nv = to_device(n if n_valid is None else n_valid, torch.int32,
                   dev).expand(p)

    starts, counts = destination_slices(local_sorted, splitter_keys,
                                        nv)                 # (p_src, p_dst)
    sent_counts = torch.clamp(counts, max=cap)
    recv, recv_counts = _dense_send(local_sorted[:, None], starts[:, None],
                                    sent_counts[:, None], cap, comm,
                                    cfg.kernel_policy)
    # recv (p_dst, p_src, 1, cap)

    # -- the spill channel: position i spills iff its offset in its
    # destination slice is past that pair's capacity
    at = torch.arange(n, dtype=torch.int32, device=dev).expand(p, n)
    dest = torch.searchsorted(starts[:, 1:].contiguous(), at.contiguous(),
                              side="right")
    offset = at - torch.gather(starts, 1, dest)
    spilled = ((offset >= torch.gather(sent_counts, 1, dest))
               & (at < nv[:, None]))
    del dest, offset
    n_spill = spilled.sum(dim=-1, dtype=torch.int32)          # (p_src,)
    spill = dispatch.local_sort(torch.where(spilled, local_sorted, sent_hi),
                                policy=cfg.kernel_policy)
    del spilled
    # slot = n bounds every window (the merge reads each run's count)
    slot = n
    windows, s_counts = _gather_windows(
        comm.all_gather(spill[:, None]), comm.all_gather(n_spill[:, None]),
        splitter_keys[None], comm, slot)          # (p_dst, 1, p_src, slot)
    del spill

    # -- both channels as 2p runs of slot keys per destination
    runs = torch.full((p, 1, 2 * p, slot), sent_hi, dtype=recv.dtype,
                      device=dev)
    runs[:, :, :p, :cap] = recv.transpose(1, 2)
    runs[:, :, p:] = windows
    del recv, windows
    out = dispatch.merge_runs(
        runs, policy=cfg.kernel_policy, out_len=out_cap,
        counts=torch.cat([recv_counts.transpose(1, 2), s_counts], dim=-1))
    del runs
    n_recv = (recv_counts.sum(dim=1, dtype=torch.int32)
              + s_counts.sum(dim=-1, dtype=torch.int32))      # (p_dst, 1)
    trunc = torch.clamp(n_recv - out_cap, min=0)
    return out[:, 0], (n_recv - trunc)[:, 0], comm.psum(trunc)[0]


def exchange_dense_spill_batched(local_sorted: torch.Tensor,
                                 splitter_keys: torch.Tensor, *, comm: Comm,
                                 cfg: ExchangeConfig, eps: float,
                                 n_valid=None):
    """dense_spill over (p, B, n_local) shards and (B, p-1) splitters, one
    request at a time (the spill windows do not batch-fuse, as in the
    reference): B times one request's collectives. Returns as
    `exchange_dense_batched`."""
    p, batch, n = local_sorted.shape
    nv = _rows_valid(n_valid, p, batch, n, local_sorted.device)
    outs = [exchange_dense_spill(local_sorted[:, b].contiguous(),
                                 splitter_keys[b], comm=comm, cfg=cfg,
                                 eps=eps, n_valid=nv[:, b])
            for b in range(batch)]
    out, n_out, overflow = zip(*outs)
    return (torch.stack(out, dim=1), torch.stack(n_out, dim=1),
            torch.stack(overflow))


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
    nv = comm.all_gather(_rows_valid(n_valid, p, batch, n, dev))  # (p_src, B)
    # slot = n bounds every window (the merge reads each window's count)
    runs, counts = _gather_windows(everything, nv, splitter_keys, comm,
                                   n)             # (p_dst, B, p_src, n)
    n_out = counts.sum(dim=-1, dtype=torch.int32)             # (p_dst, B)
    out = dispatch.merge_runs(runs, policy=cfg.kernel_policy, counts=counts,
                              out_len=out_cap)
    del runs
    trunc = torch.clamp(n_out - out_cap, min=0)
    return out, n_out - trunc, comm.psum(trunc)


def exchange_ragged_batched(local_sorted: torch.Tensor,
                            splitter_keys: torch.Tensor, *, comm: Comm,
                            cfg: ExchangeConfig, eps: float, n_valid=None):
    """The exact alltoallv over (p, B, n_local) shards and (B, p-1)
    splitters (counterpart of exchange.py:279-308 and :415-427); returns
    as `exchange_dense_batched`. overflow counts the received keys cut at
    out_cap, which the (1+eps) guarantee rules out."""
    p, batch, n = local_sorted.shape
    dev = local_sorted.device
    out_cap = cfg.out_cap(n, p, eps)

    starts, counts = destination_slices(
        local_sorted, splitter_keys,
        _rows_valid(n_valid, p, batch, n, dev))       # (p_src, B, p_dst)
    # recv_counts[d, b, s]: keys destination d takes from source s
    recv_counts = comm.all_to_all(counts.permute(0, 2, 1)).permute(0, 2, 1)
    recv_offsets = (torch.cumsum(recv_counts, -1, dtype=torch.int32)
                    - recv_counts)                    # (p_dst, B, p_src)
    # send_offsets[s, b, d]: where source s's slice lands in d's buffer
    send_offsets = comm.all_to_all(
        recv_offsets.permute(0, 2, 1)).permute(0, 2, 1)
    buf = torch.full((p, batch, out_cap), hi_sentinel(local_sorted.dtype),
                     dtype=local_sorted.dtype, device=dev)
    buf = comm.ragged_all_to_all(local_sorted, buf, starts, counts,
                                 send_offsets)        # (p_dst, B, out_cap)
    n_recv = recv_counts.sum(dim=-1, dtype=torch.int32)
    # the runs as written: a run past out_cap was cut at the buffer's end
    kept = torch.clamp(torch.clamp(recv_offsets + recv_counts, max=out_cap)
                       - recv_offsets, min=0)
    out = dispatch.merge_ragged(buf, recv_offsets, kept,
                                policy=cfg.kernel_policy,
                                slot=cfg.ragged_slot(n, p, eps))
    trunc = torch.clamp(n_recv - out_cap, min=0)
    return out, n_recv - trunc, comm.psum(trunc)


_STRATEGIES_BATCHED = {
    "dense": exchange_dense_batched,
    "dense_spill": exchange_dense_spill_batched,
    "allgather": exchange_allgather_batched,
    "ragged": exchange_ragged_batched,
}


def exchange_batched(local_sorted: torch.Tensor,
                     splitter_keys: torch.Tensor, *, comm: Comm,
                     cfg: ExchangeConfig | None = None, eps: float = 0.05,
                     n_valid=None):
    """Redistribute B requests at once: local_sorted (p, B, n_local),
    splitter_keys (B, p-1) -> (out (p, B, out_cap), n_valid (p, B),
    overflow (B,)). n_valid may be None, a scalar, a (B,) vector or a
    (p, B) count per (shard, request) row."""
    cfg = cfg or ExchangeConfig()
    fn = _STRATEGIES_BATCHED.get(cfg.strategy)
    if fn is None:
        raise ValueError(
            f"unknown exchange strategy {cfg.strategy!r}; available: "
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
