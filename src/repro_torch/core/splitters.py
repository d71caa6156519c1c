"""HSS splitter determination (the paper's core contribution, Section 4).

Counterpart of `repro.core.splitters`. For every target rank t_i = N*i/p
the algorithm keeps a splitter interval, the tightest pair of ranked keys
bracketing t_i. Each round samples the keys inside the still-unsatisfied
intervals, ranks the sample exactly with one histogram, and tightens every
interval (Lemmas 4.4/4.5, Theorem 4.8).

The port's layout: the p shards are the leading axis of one tensor, and
the batched engine's B requests the next one, (p, B, n_local). Per-shard
work (sampling, the probe sort, ranking) runs over all p*B rows at
once; the collectives go through `Comm`, one call per phase whatever B
is; the replicated interval state is held once, (B, p-1).
`hss_splitters` is `hss_splitters_batched` at B = 1. `lax.scan` over the k
rounds becomes a Python loop, and the reference's `lax.cond` early exit
becomes a host `if` on every request's replicated `satisfied` vector — one
device-to-host sync a round until it fires (`sync_site("hss.early_exit")`).
Each round runs inside `comm.round(j)`, and a skipped one is marked
`comm.early_exit()`, so the collective contracts
(repro_torch.analysis.contracts) can hold every round that ran. Until
all B requests are satisfied every request runs the round, satisfied ones
included, as in the reference. A skipped round records sample_count =
overflow = 0, as the reference does.

Random draws: round j calls `uniform(j)` for a (p, n_local) float32 tensor
of U[0, 1) draws, row s for shard s. All B requests share it, as the
reference's batched engine shares one stream per shard (splitters.py:345).
The driver's default draws from a seeded `torch.Generator` on the device;
tests inject the reference's own `jax.random` streams, and then the port
reproduces the reference bit for bit.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.common import (
    HSSConfig, hi_sentinel, interval_union_size, lo_sentinel, sampling_ratios)
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm
from repro_torch.runtime.syncs import sync_site, to_device

#: Collectives one non-converged round issues: ONE all_gather of the sample
#: buffers and ONE fused psum of the ranks + (n_sample, overflow) counts.
ROUND_COLLECTIVES = {"all_gather": 1, "psum": 1}

Uniform = Callable[[int], torch.Tensor]


class SplitterState(NamedTuple):
    """Replicated per-splitter interval state; tensors of shape (p-1,), or
    (B, p-1) on the batched path."""

    lo_rank: torch.Tensor    # int32, largest known rank <= t_i
    hi_rank: torch.Tensor    # int32, smallest known rank >= t_i
    lo_key: torch.Tensor     # key at lo_rank (lo sentinel when unknown)
    hi_key: torch.Tensor     # key at hi_rank (hi sentinel when unknown)
    satisfied: torch.Tensor  # bool


class SplitterStats(NamedTuple):
    """Per-round diagnostics, int32: per-round fields (k,) and rounds_used
    a scalar; (k, B) and (B,) on the batched path."""

    gamma_size: torch.Tensor    # |gamma_{j-1}| before round j
    sample_count: torch.Tensor  # keys sampled in round j (all shards)
    overflow: torch.Tensor      # samples dropped for buffer capacity
    n_satisfied: torch.Tensor   # satisfied splitters after round j
    rounds_used: torch.Tensor   # first all-satisfied round, 1-based


def splitter_targets(n: int, p: int, device=None) -> torch.Tensor:
    """Target ranks t_i = N*i/p for i = 1..p-1."""
    t = np.arange(1, p, dtype=np.int64) * n // p
    return to_device(t.astype(np.int32), torch.int32, device)


def init_state(p: int, n: int, dtype: torch.dtype, device=None,
               batch: tuple = ()) -> SplitterState:
    m = p - 1
    shape = tuple(batch) + (m,)
    return SplitterState(
        lo_rank=torch.zeros(shape, dtype=torch.int32, device=device),
        hi_rank=torch.full(shape, n, dtype=torch.int32, device=device),
        lo_key=torch.full(shape, lo_sentinel(dtype), dtype=dtype,
                          device=device),
        hi_key=torch.full(shape, hi_sentinel(dtype), dtype=dtype,
                          device=device),
        satisfied=torch.zeros(shape, dtype=torch.bool, device=device))


def refine(state: SplitterState, probes: torch.Tensor,
           probe_ranks: torch.Tensor, targets: torch.Tensor,
           tol: int) -> SplitterState:
    """Tighten every splitter interval with freshly ranked probes.

    probes (..., M) sorted ascending (sentinel-padded tail), probe_ranks
    (..., M) nondecreasing (sentinels rank N), state (..., p-1): leading
    axes are independent requests. targets (p-1,) or (..., p-1), and tol
    an int or a tensor broadcasting against them (multistage's per-row
    n)."""
    probe_ranks = probe_ranks.contiguous()
    tgt = targets.expand(probe_ranks.shape[:-1] + targets.shape[-1:])
    j = torch.searchsorted(probe_ranks, tgt.contiguous(), side="left")
    j = torch.clamp(j, max=probe_ranks.shape[-1] - 1)
    cand_hi_rank = torch.gather(probe_ranks, -1, j)
    cand_hi_key = torch.gather(probes, -1, j)
    jm = torch.clamp(j - 1, min=0)
    has_lo = j > 0
    cand_lo_rank = torch.where(has_lo, torch.gather(probe_ranks, -1, jm), 0)
    cand_lo_key = torch.where(has_lo, torch.gather(probes, -1, jm),
                              state.lo_key)

    take_lo = cand_lo_rank > state.lo_rank
    take_hi = cand_hi_rank < state.hi_rank
    lo_rank = torch.where(take_lo, cand_lo_rank, state.lo_rank)
    lo_key = torch.where(take_lo, cand_lo_key, state.lo_key)
    hi_rank = torch.where(take_hi, cand_hi_rank, state.hi_rank)
    hi_key = torch.where(take_hi, cand_hi_key, state.hi_key)
    satisfied = ((targets - lo_rank) <= tol) | ((hi_rank - targets) <= tol)
    return SplitterState(lo_rank, hi_rank, lo_key, hi_key, satisfied)


def active_union_size(state: SplitterState,
                      targets: torch.Tensor) -> torch.Tensor:
    """|gamma|: union (rank space) of the unsatisfied splitters' intervals;
    satisfied splitters contribute empty [t_i, t_i] intervals. One value
    per request."""
    lo = torch.where(state.satisfied, targets, state.lo_rank)
    hi = torch.where(state.satisfied, targets, state.hi_rank)
    return interval_union_size(lo, hi)


def gamma_membership(x: torch.Tensor, state: SplitterState) -> torch.Tensor:
    """Boolean mask (x's shape): which keys lie in an active interval, i.e.
    lo_key_i < x < hi_key_i for some unsatisfied i (`dispatch.gamma_mask`:
    two searchsorteds plus a prefix-sum lookup). x (..., n); the state's
    leading axes broadcast against x's, right-aligned ((p-1,) against
    (p, n) shard rows, (B, p-1) against (p, B, n))."""
    return dispatch.gamma_mask(x, state.lo_key, state.hi_key,
                               state.satisfied)


def choose_splitters(state: SplitterState, targets: torch.Tensor):
    """Final splitter keys: the closer satisfied side of each interval."""
    pick_lo = (targets - state.lo_rank) <= (state.hi_rank - targets)
    keys = torch.where(pick_lo, state.lo_key, state.hi_key)
    ranks = torch.where(pick_lo, state.lo_rank, state.hi_rank)
    return keys, ranks


def _sample_round(local_sorted: torch.Tensor, state: SplitterState,
                  prob: torch.Tensor, cap: int, u: torch.Tensor,
                  kernel_policy: str = "auto"):
    """Bernoulli-sample each (shard, request) row's active-interval keys
    into a sorted, sentinel-padded (p, B, min(cap, n_local)) buffer; all B
    requests share the shard's draws u (p, n_local), or each row has its
    own, u (p, B, n_local). Returns (vals, sampled (p, B), overflow (p,
    B)). The kernel route compacts the sorted rows (K6); the torch route
    sorts each masked row, as the reference does (splitters.py:168): the
    same bits (`dispatch.sample_compact`)."""
    return dispatch.sample_compact(local_sorted, state.lo_key, state.hi_key,
                                   state.satisfied, u, prob, cap,
                                   policy=kernel_policy)


def hss_splitters_batched(local_sorted: torch.Tensor, *, comm: Comm,
                          cfg: HSSConfig, uniform: Uniform,
                          initial_probes: torch.Tensor | None = None):
    """Determine the p-1 splitters of B independent sorts over `comm.p`
    shards, in one pipeline (counterpart of splitters.py:273-385).

    Args:
      local_sorted: (p, B, n_local) keys; row (s, b) is request b's shard
        s, sorted ascending.
      comm: the collective seam; its `p` is the shard count. Each round
        issues one all_gather and one psum whatever B is.
      cfg: HSSConfig.
      uniform: round j -> (p, n_local) float32 U[0, 1) draws, shared by
        every request.
      initial_probes: optional (B, m) sorted probe rows to warm-start with
        (the ChaNGa trick, paper Section 7.3); sentinel-padded.

    Returns (splitter_keys (B, p-1), splitter_ranks (B, p-1), SplitterStats
    with per-round fields (k, B) and rounds_used (B,)).
    """
    p, batch, n_local = local_sorted.shape
    n = n_local * p
    dev, dtype = local_sorted.device, local_sorted.dtype
    policy = cfg.kernel_policy
    k = cfg.resolved_rounds(p)
    cap = cfg.resolved_sample_cap(p)
    tol = max(1, int(n * cfg.eps / (2 * p)))
    targets = splitter_targets(n, p, dev)
    # float32 operands on both sides of every division, as the reference's
    # weakly typed scalars are
    f_total = to_device(float(cap * p) / 2.0, torch.float32, dev)
    ratios = to_device(sampling_ratios(p, cfg.eps, k), torch.float32, dev)
    n_local_f = to_device(float(n_local), torch.float32, dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((batch,), dtype=torch.int32, device=dev)

    state = init_state(p, n, dtype, dev, batch=(batch,))
    if initial_probes is not None:
        lr = dispatch.probe_ranks(local_sorted, initial_probes,
                                  policy=policy, assume_sorted=True)
        state = refine(state, initial_probes, comm.psum(lr), targets, tol)

    gam, cnt, ovf, nsat = [], [], [], []
    done = False
    for j in range(k):
        gamma = active_union_size(state, targets)              # (B,)
        if cfg.adaptive:
            prob = torch.minimum(
                one, f_total / torch.clamp(gamma, min=1).to(torch.float32))
        else:
            prob = torch.minimum(one, ratios[j] / n_local_f).expand(batch)
        # Early exit once every request is satisfied: one host read a
        # round until it fires (the state stays satisfied after). Until
        # then satisfied requests run the round too.
        if not done:
            with sync_site("hss.early_exit"):
                done = bool(state.satisfied.all())
        with comm.round(j):
            if done:
                comm.early_exit()
                count, over = zero, zero
            else:
                vals, n_samp, s_ovf = _sample_round(
                    local_sorted, state, prob, cap, uniform(j),
                    kernel_policy=policy)
                gathered = comm.all_gather(vals)    # (p, B, cap)
                probes = dispatch.local_sort(
                    gathered.transpose(0, 1).reshape(batch, -1),
                    policy=policy)
                local_ranks = dispatch.probe_ranks(
                    local_sorted, probes, policy=policy, assume_sorted=True)
                # one fused reduction a round: ranks + sample count +
                # overflow
                packed = comm.psum(torch.cat(
                    [local_ranks, torch.stack([n_samp, s_ovf], dim=-1)],
                    dim=-1))
                state = refine(state, probes, packed[:, :-2], targets, tol)
                count, over = packed[:, -2], packed[:, -1]
        gam.append(gamma)
        cnt.append(count)
        ovf.append(over)
        nsat.append(state.satisfied.sum(dim=-1, dtype=torch.int32))

    keys, ranks = choose_splitters(state, targets)
    nsat = torch.stack(nsat)                                   # (k, B)
    all_sat = nsat >= (p - 1)
    rounds_used = torch.where(all_sat.any(dim=0),
                              1 + torch.argmax(all_sat.to(torch.int32), dim=0),
                              k).to(torch.int32)
    stats = SplitterStats(torch.stack(gam), torch.stack(cnt),
                          torch.stack(ovf), nsat, rounds_used)
    return keys, ranks, stats


def hss_splitters(local_sorted: torch.Tensor, *, comm: Comm,
                  cfg: HSSConfig, uniform: Uniform,
                  initial_probes: torch.Tensor | None = None):
    """Determine the p-1 splitters of one sort: `hss_splitters_batched` at
    B = 1. local_sorted (p, n_local) sorted rows, initial_probes (m,).

    Returns (splitter_keys (p-1,), splitter_ranks (p-1,), SplitterStats
    with per-round fields (k,) and a scalar rounds_used).
    """
    keys, ranks, stats = hss_splitters_batched(
        local_sorted[:, None], comm=comm, cfg=cfg, uniform=uniform,
        initial_probes=None if initial_probes is None
        else initial_probes[None])
    return keys[0], ranks[0], SplitterStats(*(f[..., 0] for f in stats))


def heavy_candidates(sample_sorted: torch.Tensor, *, max_heavy: int,
                     min_count: int) -> torch.Tensor:
    """Heavy-hitter candidates of each sorted, sentinel-padded sample row
    (counterpart of splitters.py:388-410, rows batched): a key is a
    candidate when its run in the row is at least `min_count` long.
    sample_sorted (..., S) -> (..., min(S, max_heavy)) ascending distinct
    candidates, hi-sentinel padded; a sentinel is never a candidate.

    Callers gather every shard's sample first, so each shard's candidate
    set is the same (the value is held once)."""
    sent = hi_sentinel(sample_sorted.dtype)
    idx = torch.arange(sample_sorted.shape[-1], device=sample_sorted.device)
    ll = torch.searchsorted(sample_sorted, sample_sorted, side="left")
    rr = torch.searchsorted(sample_sorted, sample_sorted, side="right")
    is_head = (idx == ll) & ((rr - ll) >= min_count) & (sample_sorted != sent)
    compact = torch.sort(torch.where(is_head, sample_sorted, sent),
                         dim=-1).values
    return compact[..., :max_heavy]
