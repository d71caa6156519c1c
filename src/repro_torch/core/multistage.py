"""Multi-stage HSS (paper Sections 5.3, 6.1).

Counterpart of `repro.core.multistage`. The p = r1*r2 shards form an
(outer, inner) grid, shard s = outer*r2 + inner. Stage 1 splits the keys
into r1 groups with HSS over all p shards and exchanges them along the
outer axis only; stage 2 sorts within each group along the inner axis.
The stage-1 histogram has r1-1 splitters, and stage-2 traffic stays in a
group (the paper's node-level two-phase optimisation).

The port runs each stage's groups as the batch axis (`Comm.along`): the
r2 stage-1 exchanges and the r1 stage-2 sorts are each one pipeline, one
collective per phase for every group and request.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.common import HSSConfig, hi_sentinel, lo_sentinel
from repro_torch.core.exchange import ExchangeConfig, exchange_batched
from repro_torch.core.splitters import (
    SplitterState, Uniform, _sample_round, active_union_size,
    choose_splitters, refine)
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm
from repro_torch.runtime import trace
from repro_torch.runtime.syncs import to_device


#: The stage-1 exchange's output slack: a group's shards receive up to
#: twice their share (multistage.py:86).
STAGE1_OUT_SLACK = 2.0


def hss_splitters_general(local_sorted: torch.Tensor, *, comm: Comm,
                          num_parts: int, cfg: HSSConfig, uniform: Uniform,
                          n_valid: torch.Tensor | None = None,
                          first_round: int = 0):
    """HSS splitter determination with the shard count (`comm.p`) apart
    from the part count (counterpart of multistage.py:26-79).

    local_sorted (P, R, n_local): row (s, r) is shard s of sort r, sorted
    ascending, a sentinel-padded tail allowed. n_valid (R,): the real keys
    of each sort over its P shards (default P*n_local); targets and
    tolerance follow it per row. uniform: round j -> (P, n_local) draws
    shared by the rows, or (P, R, n_local), a row each.

    Unlike `hss_splitters_batched`, and as the reference: every one of
    the k rounds runs (no early exit), the probability is always the
    adaptive one, the tolerance is float32 arithmetic on the row's n, the
    sample target is cap*P/2 with the cap of `num_parts`, and each round
    issues one all_gather and three psums (ranks, sample count, sample
    overflow). `first_round` numbers the rounds (`comm.round`): stage
    2's follow stage 1's.

    Returns (keys (R, num_parts-1), ranks (R, num_parts-1), stats: the
    per-round (k, R) gamma sizes, sample counts and sample overflows).
    """
    _, rows, n_local = local_sorted.shape
    dev, dtype = local_sorted.device, local_sorted.dtype
    policy = cfg.kernel_policy
    n = (torch.full((rows,), n_local * comm.p, dtype=torch.int32, device=dev)
         if n_valid is None else n_valid.to(torch.int32))
    k = cfg.resolved_rounds(num_parts)
    cap = cfg.resolved_sample_cap(num_parts)
    f32 = dict(dtype=torch.float32, device=dev)
    tol = torch.clamp((n.to(torch.float32)
                       * to_device(cfg.eps, torch.float32, dev)
                       / to_device(float(2 * num_parts), torch.float32, dev)
                       ).to(torch.int32), min=1)[:, None]
    targets = (torch.arange(1, num_parts, dtype=torch.int32, device=dev)
               * n[:, None]) // num_parts
    f_total = to_device(float(cap * comm.p) / 2.0, torch.float32, dev)
    one = torch.ones((), **f32)

    m = num_parts - 1
    state = SplitterState(
        lo_rank=torch.zeros((rows, m), dtype=torch.int32, device=dev),
        hi_rank=n[:, None].expand(rows, m).contiguous(),
        lo_key=torch.full((rows, m), lo_sentinel(dtype), dtype=dtype,
                          device=dev),
        hi_key=torch.full((rows, m), hi_sentinel(dtype), dtype=dtype,
                          device=dev),
        satisfied=torch.zeros((rows, m), dtype=torch.bool, device=dev))
    gam, cnt, ovf = [], [], []
    for j in range(k):
        gamma = active_union_size(state, targets)             # (R,)
        prob = torch.minimum(
            one, f_total / torch.clamp(gamma, min=1).to(torch.float32))
        with comm.round(first_round + j):
            vals, n_samp, s_ovf = _sample_round(
                local_sorted, state, prob, cap, uniform(j),
                kernel_policy=policy)
            probes = dispatch.local_sort(
                comm.all_gather(vals).transpose(0, 1).reshape(rows, -1),
                policy=policy)
            ranks = comm.psum(dispatch.probe_ranks(
                local_sorted, probes, policy=policy, assume_sorted=True))
            state = refine(state, probes, ranks, targets, tol)
            cnt.append(comm.psum(n_samp))
            ovf.append(comm.psum(s_ovf))
        gam.append(gamma)
    keys, ranks = choose_splitters(state, targets)
    return keys, ranks, (torch.stack(gam), torch.stack(cnt),
                         torch.stack(ovf))


def two_stage_sort(x, stages: tuple | None = None, seed: int = 0,
                   hss_cfg: HSSConfig | None = None,
                   ex_cfg: ExchangeConfig | None = None, *, shards: int = 8,
                   device="cuda", uniform=None):
    """Legacy entry point (counterpart of core/multistage.py:116): x (n,)
    sorted over the (r1, r2) = `stages` grid of `shards` emulated shards
    (default `driver.factor_stages(shards)`), through the shared driver
    at B = 1. Returns, as the reference does, (out (r1, r2, cap), counts
    (r1, r2), overflow). `uniform` is numbered as `two_stage_sort_batched`
    takes it."""
    from repro_torch.core.hss import _driver
    from repro_torch.sort.driver import factor_stages
    from repro_torch.sort.partitioners import null_stats_batched

    r1, r2 = stages or factor_stages(shards)
    if r1 * r2 != shards:
        raise ValueError(f"stages {(r1, r2)} != {shards} shards")
    policy = (hss_cfg or HSSConfig()).kernel_policy

    def sort_fn(rows, comm, draws):
        batch, dev = rows.shape[1], rows.device
        out, n_valid, ovf = two_stage_sort_batched(
            rows, comm=comm, r1=r1, r2=r2, uniform=draws, hss_cfg=hss_cfg,
            ex_cfg=ex_cfg)
        return (out, n_valid,
                torch.zeros((batch, 0), dtype=rows.dtype, device=dev),
                torch.zeros((batch, 0), dtype=torch.int32, device=dev),
                ovf, null_stats_batched(batch, device=dev))

    res = _driver(sort_fn, x, shards=shards, seed=seed, device=device,
                  uniform=uniform, local_sort_fn=dispatch.local_sort_fn(policy))
    return (res.shards.reshape(r1, r2, -1), res.counts.reshape(r1, r2),
            res.overflow)


def two_stage_sort_batched(local: torch.Tensor, *, comm: Comm, r1: int,
                           r2: int, uniform, hss_cfg: HSSConfig | None = None,
                           ex_cfg: ExchangeConfig | None = None):
    """Two-stage HSS of B requests over the (r1, r2) grid (counterpart of
    multistage.py:82-116): local (p, B, n_local) unsorted shard rows ->
    (out (p, B, out_cap) sorted sentinel-padded rows, n_valid (p, B),
    overflow (B,)).

    Under a profiler it records span `stage1` around stage 1's splitters
    and exchange (its merge inside), and `stage2` around stage 2 from the
    fold of the stage-1 rows to the final unfold (`runtime/trace.py`).

    uniform: (j, n) -> (p, n) draws; draws 0..k1-1 are stage 1's rounds
    (n = n_local), draws k1.. stage 2's (n = the stage-1 output row).
    Each request shares them, as each of the reference's per-row calls
    takes the same rng (repro/sort/partitioners.py:394-412).

    overflow counts every group's dropped keys. The reference returns one
    shard's value (its shard_map reads a group-local psum as replicated),
    so it equals the port's when only the first group drops keys (ROADMAP
    queue 3)."""
    hss_cfg = hss_cfg or HSSConfig()
    ex_cfg = ex_cfg or ExchangeConfig(kernel_policy=hss_cfg.kernel_policy)
    eps = hss_cfg.eps
    p, batch, n_local = local.shape
    with trace.span("local_sort"):
        local_sorted = dispatch.local_sort(
            local, policy=hss_cfg.kernel_policy)

    # -- stage 1: r1 groups over all p shards, exchanged along outer
    k1 = hss_cfg.resolved_rounds(r1)
    outer = comm.along("outer", r1, r2)
    with trace.span("stage1"):
        with trace.span("splitters"):
            g_keys, _, _ = hss_splitters_general(
                local_sorted, comm=comm, num_parts=r1, cfg=hss_cfg,
                uniform=lambda j: uniform(j, n_local))
        with trace.span("exchange"):
            mid, mid_valid, ovf1 = exchange_batched(
                outer.fold(local_sorted), outer.rows(g_keys), comm=outer,
                cfg=dataclasses.replace(ex_cfg, out_slack=STAGE1_OUT_SLACK),
                eps=eps)
        mid = outer.unfold(mid)                           # (p, B, cap1)
        mid_valid = outer.unfold(mid_valid)               # (p, B)
    del local_sorted

    # -- stage 2: HSS within each group along inner, on the padded rows
    inner = comm.along("inner", r1, r2)
    cap1 = mid.shape[-1]

    def stage2_draws(j):
        u = uniform(k1 + j, cap1)[:, None].expand(p, batch, cap1)
        return inner.fold(u)

    with trace.span("stage2"):
        mid, mid_valid = inner.fold(mid), inner.fold(mid_valid)
        group_n = inner.psum(mid_valid)                   # (r1*B,)
        with trace.span("splitters"):
            s_keys, _, _ = hss_splitters_general(
                mid, comm=inner, num_parts=r2, cfg=hss_cfg,
                uniform=stage2_draws, n_valid=group_n, first_round=k1)
        with trace.span("exchange"):
            out, n_valid, ovf2 = exchange_batched(
                mid, s_keys, comm=inner, cfg=ex_cfg, eps=eps,
                n_valid=mid_valid)
        out, n_valid = inner.unfold(out), inner.unfold(n_valid)
    overflow = (ovf1.reshape(r2, batch).sum(dim=0, dtype=torch.int32)
                + ovf2.reshape(r1, batch).sum(dim=0, dtype=torch.int32))
    return out, n_valid, overflow
