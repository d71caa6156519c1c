"""Probe ranks over rows (counterpart of repro.kernels.histogram.ops)."""
from __future__ import annotations

import torch

from repro_torch.kernels.histogram.kernel import probe_rank_count


def probe_ranks(keys: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """rank[r, m] = #{keys[r] < probes[r, m]}; keys need not be sorted.

    keys (rows, n); probes (rows, M), or (M,) shared by every row."""
    if probes.dim() == 1:
        probes = probes.expand(keys.shape[0], -1)
    return probe_rank_count(keys, probes.contiguous())
