"""Shared utilities for the HSS core: sentinels, rounding, round/sample math.

Counterpart of `repro.core.common`. Keys in the core are int32 tensors of
static shape; "absent" slots in sample and exchange buffers hold the
dtype's +sentinel, which is greater than any real key. Callers must not
feed sentinel-valued keys: the front door's adapters (repro_torch.sort
.adapters) tag such inputs so that they stay strictly below it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def hi_sentinel(dtype: torch.dtype):
    """The dtype's largest value (+inf for floats), as a Python scalar."""
    if dtype.is_floating_point:
        return math.inf
    return torch.iinfo(dtype).max


def lo_sentinel(dtype: torch.dtype):
    """The dtype's smallest value (-inf for floats), as a Python scalar."""
    if dtype.is_floating_point:
        return -math.inf
    return torch.iinfo(dtype).min


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def auto_rounds(p: int, eps: float) -> int:
    """Optimal round count k = log(log p / eps) (Theorem 4.8), at least 1."""
    if p <= 1:
        return 1
    return max(1, round(math.log(max(math.e, 2.0 * math.log(p) / eps))))


def final_sampling_ratio(p: int, eps: float) -> float:
    """s_k = 2 ln p / eps (Lemma 4.3): the ratio that pins every splitter."""
    return 2.0 * math.log(max(p, 2)) / eps


@dataclasses.dataclass(frozen=True)
class HSSConfig:
    """Configuration of the HSS splitter-determination stage.

    Field for field the reference's `repro.core.common.HSSConfig`:
    eps (load-balance slack), rounds (k; 0 => auto_rounds), sample_per_shard
    (per-shard per-round sample capacity; 0 => sized from theory with
    Chernoff slack), adaptive (per-round probability target_sample /
    |gamma_j| as in the paper's implementation, else the fixed ratios of
    Theorem 4.7), out_slack, capacity_scale (multiplier on every static
    buffer) and kernel_policy ("auto" | "kernel" | "torch", see
    repro_torch.kernels.dispatch).
    """

    eps: float = 0.05
    rounds: int = 0
    sample_per_shard: int = 0
    adaptive: bool = True
    out_slack: float = 1.0
    capacity_scale: float = 1.0
    kernel_policy: str = "auto"

    def resolved_rounds(self, p: int) -> int:
        return self.rounds if self.rounds > 0 else auto_rounds(p, self.eps)

    def resolved_sample_cap(self, p: int) -> int:
        if self.sample_per_shard > 0:
            cap = self.sample_per_shard
        else:
            k = self.resolved_rounds(p)
            ratio = final_sampling_ratio(p, self.eps) ** (1.0 / k)
            # Expected per-shard sample per round is ~ratio (round 1) and
            # <= 4*ratio later rounds (Lemma 4.6, constants incl.); x2 slack.
            cap = int(round_up(max(8, math.ceil(8.0 * ratio)), 8))
        if self.capacity_scale != 1.0:
            cap = int(round_up(max(8, int(cap * self.capacity_scale)), 8))
        return cap


def sampling_ratios(p: int, eps: float, k: int) -> np.ndarray:
    """Theory schedule s_j = (2 ln p / eps)^{j/k}, j = 1..k (Theorem 4.7)."""
    s_k = final_sampling_ratio(p, eps)
    return np.array([s_k ** ((j + 1) / k) for j in range(k)], dtype=np.float64)


def interval_union_size(lo_rank: torch.Tensor,
                        hi_rank: torch.Tensor) -> torch.Tensor:
    """Size of the union of splitter intervals [lo_i, hi_i] in rank space.

    Intervals are monotone (lo and hi nondecreasing in i), so the union is
    sum_i max(0, hi_i - max(lo_i, cummax(hi)_{i-1})). Intervals run along
    the last axis; leading axes are independent requests. Returns the
    ranks' dtype (int32 on the splitter path, as in the reference).
    """
    cummax = torch.cummax(hi_rank, dim=-1).values
    cummax_prev = torch.cat([lo_rank[..., :1], cummax[..., :-1]], dim=-1)
    gaps = torch.clamp(hi_rank - torch.maximum(lo_rank, cummax_prev), min=0)
    return gaps.sum(dim=-1, dtype=hi_rank.dtype)
