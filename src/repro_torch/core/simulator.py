"""Logical-p simulator of the partitioning algorithms, in rank space
(the port's copy of repro.core.simulator; NumPy only).

Splitter determination for *distinct* keys is purely comparison-based, so its
behaviour (rounds needed, sample sizes, interval shrinkage, achieved balance)
is distribution-free — we can simulate it with keys == ranks (the identity
dataset) and never materialize N = p * n_per keys. This reproduces the paper's
large-scale numbers (Table 4: p up to 32768 with 1M keys/processor; Figure 2
sample-size comparisons) on a single host exactly, while the sort pipeline
covers the real keys, the exchange and duplicates at the p of one device.

All routines use numpy and a seeded Generator; nothing runs on a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.common import auto_rounds, sampling_ratios


@dataclasses.dataclass
class SimResult:
    rounds_used: int
    sample_sizes: list            # per-round overall sample size
    gamma_sizes: list             # |gamma_{j-1}| before each round
    total_sample: int
    achieved_eps: float           # max_i |chosen_rank_i - t_i| * 2p / N
    max_load_frac: float          # max shard load / (N/p)
    all_satisfied: bool


def _interval_union(lo: np.ndarray, hi: np.ndarray) -> int:
    cummax_prev = np.concatenate([lo[:1], np.maximum.accumulate(hi)[:-1]])
    return int(np.maximum(hi - np.maximum(lo, cummax_prev), 0).sum())


def _sample_intervals(rng, lo, hi, prob):
    """Bernoulli(prob) over the union of [lo_i, hi_i) rank intervals.

    Returns sorted unique sampled ranks. Intervals are merged first so
    overlapping (identical) intervals are not double-sampled.
    """
    # Merge to disjoint segments.
    segs = []
    cur_lo, cur_hi = None, None
    for a, b in zip(lo, hi):
        if b <= a:
            continue
        if cur_lo is None:
            cur_lo, cur_hi = a, b
        elif a <= cur_hi:
            cur_hi = max(cur_hi, b)
        else:
            segs.append((cur_lo, cur_hi))
            cur_lo, cur_hi = a, b
    if cur_lo is not None:
        segs.append((cur_lo, cur_hi))
    out = []
    for a, b in segs:
        ln = int(b - a)
        cnt = rng.binomial(ln, min(prob, 1.0))
        if cnt:
            out.append(rng.choice(ln, size=min(cnt, ln), replace=False) + a)
    if not out:
        return np.empty((0,), np.int64)
    return np.sort(np.concatenate(out))


def simulate_hss(p: int, n_per: int, eps: float = 0.05, *,
                 sample_per_round: int | None = None, rounds: int | None = None,
                 adaptive: bool = True, max_rounds: int = 64,
                 seed: int = 0) -> SimResult:
    """Run the exact HSS splitter refinement at logical scale p.

    sample_per_round: overall per-round sample target F (the paper's Table 4
    uses F = 5p). adaptive=True matches the implementation (Section 6.2);
    adaptive=False uses the fixed Theorem 4.7 ratio schedule.
    """
    rng = np.random.default_rng(seed)
    n = p * n_per
    m = p - 1
    targets = (np.arange(1, p, dtype=np.int64) * n) // p
    tol = max(1, int(n * eps / (2 * p)))
    k = rounds if rounds else auto_rounds(p, eps)
    if sample_per_round is None:
        sample_per_round = 5 * p  # paper's practical default
    ratios = sampling_ratios(p, eps, k)

    lo = np.zeros(m, np.int64)
    hi = np.full(m, n, np.int64)
    satisfied = np.zeros(m, bool)

    gamma_sizes, sample_sizes = [], []
    rounds_used = 0
    limit = k if not adaptive else max_rounds
    for j in range(limit):
        act_lo = np.where(satisfied, targets, lo)
        act_hi = np.where(satisfied, targets, hi)
        gamma = _interval_union(act_lo, act_hi)
        gamma_sizes.append(gamma)
        if adaptive:
            prob = min(1.0, sample_per_round / max(gamma, 1))
        else:
            prob = min(1.0, ratios[j] * p / n)
        ranks = _sample_intervals(rng, act_lo, act_hi, prob)
        sample_sizes.append(int(ranks.size))
        if ranks.size:
            # keys == ranks: refine directly (same math as splitters.refine).
            idx = np.searchsorted(ranks, targets, side="left")
            idxc = np.minimum(idx, ranks.size - 1)
            cand_hi = ranks[idxc]
            cand_lo = np.where(idx > 0, ranks[np.maximum(idx - 1, 0)], 0)
            has_hi = cand_hi >= targets
            take_hi = has_hi & (cand_hi < hi)
            hi = np.where(take_hi, cand_hi, hi)
            take_lo = (idx > 0) & (cand_lo > lo)
            lo = np.where(take_lo, cand_lo, lo)
            satisfied = ((targets - lo) <= tol) | ((hi - targets) <= tol)
        rounds_used = j + 1
        if satisfied.all():
            break

    d_lo = targets - lo
    d_hi = hi - targets
    chosen = np.where(d_lo <= d_hi, lo, hi)
    err = np.abs(chosen - targets)
    bounds = np.concatenate([[0], chosen, [n]])
    loads = np.diff(bounds)
    return SimResult(
        rounds_used=rounds_used,
        sample_sizes=sample_sizes,
        gamma_sizes=gamma_sizes,
        total_sample=int(np.sum(sample_sizes)),
        achieved_eps=float(err.max() * 2 * p / n) if m else 0.0,
        max_load_frac=float(loads.max() * p / n),
        all_satisfied=bool(satisfied.all()),
    )


def simulate_sample_sort_random(p: int, n_per: int, total_sample: int,
                                seed: int = 0) -> float:
    """Random-sampling sample sort: returns max load / (N/p) (Theorem 3.1)."""
    rng = np.random.default_rng(seed)
    n = p * n_per
    cnt = rng.binomial(n, min(1.0, total_sample / n))
    ranks = np.sort(rng.choice(n, size=min(cnt, n), replace=False))
    if ranks.size < p:
        return float("inf")
    sidx = (np.arange(1, p, dtype=np.int64) * ranks.size) // p
    bounds = np.concatenate([[0], ranks[sidx], [n]])
    return float(np.diff(bounds).max() * p / n)


def simulate_sample_sort_regular(p: int, n_per: int, s: int) -> float:
    """Regular sampling (PSRS): deterministic; returns max load frac."""
    n = p * n_per
    per = []
    for i in range(p):
        base = i * n_per
        idx = base + ((np.arange(s, dtype=np.int64) + 1) * n_per) // (s + 1)
        per.append(idx)
    sample = np.sort(np.concatenate(per))
    sidx = (np.arange(1, p, dtype=np.int64) * (s * p)) // p
    bounds = np.concatenate([[0], sample[sidx], [n]])
    return float(np.diff(bounds).max() * p / n)


def simulate_ams(p: int, n_per: int, eps: float, total_sample: int,
                 seed: int = 0):
    """AMS scanning (Lemma A.1). Returns (ok, max_load_frac)."""
    rng = np.random.default_rng(seed)
    n = p * n_per
    cnt = rng.binomial(n, min(1.0, total_sample / n))
    ranks = np.sort(rng.choice(n, size=min(cnt, n), replace=False))
    cap = int((1.0 + eps) * n / p)
    b = 0
    bounds = [0]
    ok = True
    for _ in range(p - 1):
        i = np.searchsorted(ranks, b + cap, side="right") - 1
        if i < 0 or ranks[i] <= b:
            # Benign iff everything left fits on one processor (paper App. A:
            # trailing processors may end up empty); else the sample was too
            # sparse and some processor must exceed cap.
            if b + cap < n:
                ok = False
            bounds.append(b)
            continue
        b = int(ranks[i])
        bounds.append(b)
    bounds.append(n)
    loads = np.diff(bounds)
    return ok and loads.max() <= cap, float(loads.max() * p / n)


def min_sample_for_balance(fn, target_frac: float, lo: int, hi: int,
                           trials: int = 5, seed: int = 0) -> int:
    """Smallest total sample size for which `fn(sample)` meets target_frac in
    all trials — bisection used by the Figure 2 benchmark."""
    def ok(s):
        return all(fn(s, seed + t) <= target_frac for t in range(trials))
    if not ok(hi):
        return -1
    while lo < hi:
        mid = (lo + hi) // 2
        if ok(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo
