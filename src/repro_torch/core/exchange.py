"""Key redistribution (the data-exchange phase, paper Section 3.1 step 3).

Counterpart of `repro.core.exchange`, dense strategy: a capacity-padded
all_to_all. Each source cuts its sorted shard into p destination slices by
searchsorted against the splitters, sends at most `pair_cap` keys per
(source, destination) pair, and each destination k-way merges the p sorted
runs it receives. Keys past a pair's capacity are dropped AND counted, so
callers can detect it. HSS's balanced splitting guarantees at most
(1+eps)*N/p keys per destination, which is what makes the static `out_cap`
sound.

The other strategies (dense_spill, ragged, allgather) come with ROADMAP
queue 1 item 8.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.common import hi_sentinel, round_up
from repro_torch.kernels import dispatch
from repro_torch.kernels.merge.ops import cap_to
from repro_torch.parallel.comm import Comm

#: Collectives of one dense exchange: payload + counts all_to_all, the
#: send-side overflow psum and the receive-side truncation psum.
EXCHANGE_COLLECTIVES = {
    "dense": {"all_to_all": 2, "all_gather": 0, "psum": 2},
}


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

    local_sorted (p, n), splitter_keys (p-1,) -> (starts, counts), each
    (p, p) int32. n_valid excludes a sentinel-padded tail from the last
    slice."""
    rows, n = local_sorted.shape
    n_valid = n if n_valid is None else n_valid
    b = torch.searchsorted(
        local_sorted, splitter_keys.expand(rows, -1).contiguous(),
        side="left").to(torch.int32)
    b = torch.clamp(b, max=n_valid)
    zeros = torch.zeros((rows, 1), dtype=torch.int32,
                        device=local_sorted.device)
    ends_last = torch.full((rows, 1), n_valid, dtype=torch.int32,
                           device=local_sorted.device)
    starts = torch.cat([zeros, b], dim=1)
    ends = torch.cat([b, ends_last], dim=1)
    return starts, ends - starts


def exchange_dense(local_sorted: torch.Tensor, splitter_keys: torch.Tensor,
                   *, comm: Comm, cfg: ExchangeConfig, eps: float):
    """-> (out (p, out_cap) sorted sentinel-padded rows, n_valid (p,),
    overflow scalar: dropped keys, send and receive side)."""
    p, n = local_sorted.shape
    dev = local_sorted.device
    cap = cfg.pair_cap(n, p)
    out_cap = cfg.out_cap(n, p, eps)
    sent_hi = hi_sentinel(local_sorted.dtype)

    starts, counts = destination_slices(local_sorted, splitter_keys)
    sent_counts = torch.minimum(counts, torch.tensor(cap, dtype=torch.int32,
                                                     device=dev))
    overflow = comm.psum((counts - sent_counts).sum(dim=1, dtype=torch.int32))

    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    # (p_src, p_dst, cap) gather index into each source row, built once
    idx = torch.clamp(starts.to(torch.int64)[:, :, None] + pos, max=n - 1)
    vals = torch.gather(local_sorted, 1, idx.reshape(p, p * cap))
    del idx
    valid = pos < sent_counts[:, :, None]
    buf = torch.where(valid, vals.reshape(p, p, cap), sent_hi)

    recv = comm.all_to_all(buf)                       # (p_dst, p_src, cap)
    recv_counts = comm.all_to_all(sent_counts[:, :, None])[:, :, 0]
    # p sorted sentinel-tailed runs of cap keys per destination -> merge
    merged = dispatch.merge_runs(recv, policy=cfg.kernel_policy)
    out = cap_to(merged, out_cap)
    n_recv = recv_counts.sum(dim=1, dtype=torch.int32)
    # Receive-side truncation (only possible when the splitting violated
    # its eps guarantee) is overflow too.
    trunc = torch.clamp(n_recv - out_cap, min=0)
    overflow = overflow + comm.psum(trunc)
    return out, n_recv - trunc, overflow


def exchange(local_sorted: torch.Tensor, splitter_keys: torch.Tensor, *,
             comm: Comm, cfg: ExchangeConfig | None = None,
             eps: float = 0.05):
    cfg = cfg or ExchangeConfig()
    if cfg.strategy != "dense":
        raise NotImplementedError(
            f"exchange strategy {cfg.strategy!r} is not ported yet "
            "(ROADMAP queue 1 item 8); the port has 'dense'")
    return exchange_dense(local_sorted, splitter_keys, comm=comm, cfg=cfg,
                          eps=eps)
