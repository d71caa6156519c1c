"""Single-stage AMS sort baseline (paper Section 3.6, Appendix A).

Counterpart of `repro.core.ams`. One Bernoulli sampling round, one
histogram round (the sample's exact ranks: K4s over the sorted shards,
one psum), then the scanning algorithm: give maximal runs of sample
buckets to consecutive shards so that none exceeds (1+eps)N/p. A locally
balanced splitting with a Theta(p(log p + 1/eps)) sample (Lemma A.1).

The reference's scan (`lax.scan` of p-1 steps, ams.py:37-51) runs here as
p-1 steps of tensor ops over all B requests at once, on the device, with
no host sync.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.sample_sort import (
    bernoulli_sample_rows, gather_rows, sample_cap)
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm


def ams_sample_size(p: int, eps: float, n: int) -> int:
    """Theta(p * max(2/eps, 2 ln N)), Lemma A.1."""
    return int(p * max(2.0 / eps, 2.0 * math.log(max(n, 2))))


def ams_sort(x, shards: int = 8, seed: int = 0, eps: float = 0.05,
             total_sample: int | None = None, ex_cfg=None,
             kernel_policy: str = "auto", *, device="cuda", uniform=None):
    """Legacy entry point (counterpart of core/ams.py:96): AMS sort of a
    1-D array over `shards` emulated shards, as a SortResult whose
    stats.n_satisfied is p-1 where the scan succeeded, else 0 (a shim
    over `driver.run_batched` at B = 1). `uniform` is the (j, n) -> (p,
    n) draws; AMS takes draw 0 once."""
    from repro_torch.core.exchange import ExchangeConfig, exchange_batched
    from repro_torch.core.hss import _driver
    from repro_torch.sort.partitioners import null_stats_batched

    ex_cfg = ex_cfg or ExchangeConfig(kernel_policy=kernel_policy)

    def sort_fn(rows, comm, draws):
        p, batch, n_local = rows.shape
        local_sorted = dispatch.local_sort(rows, policy=kernel_policy)
        keys, ranks, ovf, ok = ams_splitters(
            local_sorted, comm=comm, eps=eps, u=draws(0, n_local),
            total_sample=total_sample, kernel_policy=kernel_policy)
        out, n_valid, ex_ovf = exchange_batched(
            local_sorted, keys, comm=comm, cfg=ex_cfg, eps=eps)
        sat = torch.where(ok, p - 1, 0).to(torch.int32)
        return (out, n_valid, keys, ranks, ovf + ex_ovf,
                null_stats_batched(batch, sat, device=rows.device))

    return _driver(sort_fn, x, shards=shards, seed=seed, device=device,
                   uniform=uniform,
                   local_sort_fn=dispatch.local_sort_fn(kernel_policy))


def scanning_splitters(probes: torch.Tensor, probe_ranks: torch.Tensor, *,
                       p: int, n: int, eps: float):
    """The AMS scan over each request's ranked probes: probes and
    probe_ranks (B, M), ranks nondecreasing -> (keys (B, p-1), ranks
    (B, p-1), ok (B,)). ok is False where some shard would exceed
    (1+eps)N/p (the sample was too small: Appendix A's failure mode)."""
    cap_load = int((1.0 + eps) * n / p)    # in Python doubles (ams.py:35)
    probe_ranks = probe_ranks.contiguous()
    b = torch.zeros((probes.shape[0], 1), dtype=torch.int32,
                    device=probes.device)
    keys, ranks, oks = [], [], []
    for _ in range(p - 1):
        reach = b + cap_load
        idx = torch.clamp(torch.searchsorted(probe_ranks, reach, right=True)
                          - 1, min=0)
        nb = torch.gather(probe_ranks, 1, idx)
        advanced = nb > b
        # not advancing is benign iff the whole remainder fits one shard
        oks.append(advanced | (reach >= n))
        b = torch.where(advanced, nb, b)
        keys.append(torch.gather(probes, 1, idx))
        ranks.append(b)
    ok = torch.cat(oks, dim=1).all(dim=1) & ((n - b[:, 0]) <= cap_load)
    return torch.cat(keys, dim=1), torch.cat(ranks, dim=1), ok


def ams_splitters(local_sorted: torch.Tensor, *, comm: Comm, eps: float,
                  u: torch.Tensor, total_sample: int | None = None,
                  kernel_policy: str = "auto"):
    """Splitter determination of B requests: one sampling round and the
    scan. local_sorted (p, B, n_local) sorted rows, u (p, n_local) the
    shards' draws -> (keys (B, p-1), ranks (B, p-1), overflow (B,), ok
    (B,))."""
    p, batch, n_local = local_sorted.shape
    n = n_local * p
    total_sample = total_sample or ams_sample_size(p, eps, n)
    cap = sample_cap(total_sample, p)
    prob = min(1.0, total_sample / float(n))
    vals, n_hit = bernoulli_sample_rows(local_sorted, prob, cap, u,
                                        kernel_policy)
    with comm.round(0):     # the one sampling and histogram round
        overflow = comm.psum(torch.clamp(n_hit - cap, min=0))
        probes = dispatch.local_sort(gather_rows(vals, comm),
                                     policy=kernel_policy)
        ranks = comm.psum(dispatch.probe_ranks(local_sorted, probes,
                                               policy=kernel_policy,
                                               assume_sorted=True))
    keys, kranks, ok = scanning_splitters(probes, ranks, p=p, n=n, eps=eps)
    return keys, kranks, overflow.expand(batch), ok
