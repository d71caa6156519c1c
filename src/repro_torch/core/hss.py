"""End-to-end Histogram Sort with Sampling over emulated shards.

Counterpart of `repro.core.hss`. `hss_sort_sharded` is the shard-level
pipeline — local sort, splitter determination, exchange — over a
(p, n_local) tensor whose rows are the shards.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.common import HSSConfig
from repro_torch.core.exchange import ExchangeConfig, exchange
from repro_torch.core.splitters import SplitterStats, Uniform, hss_splitters
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm


class SortResult(NamedTuple):
    shards: torch.Tensor          # (p, out_cap) sorted, sentinel-padded
    counts: torch.Tensor          # (p,) valid keys per shard
    splitter_keys: torch.Tensor   # (p-1,)
    splitter_ranks: torch.Tensor  # (p-1,)
    overflow: torch.Tensor        # dropped keys (0 => exact)
    stats: SplitterStats | None


def hss_sort_sharded(local: torch.Tensor, *, comm: Comm, uniform: Uniform,
                     hss_cfg: HSSConfig | None = None,
                     ex_cfg: ExchangeConfig | None = None,
                     initial_probes: torch.Tensor | None = None
                     ) -> SortResult:
    """Sort (p, n_local) unsorted shards; the local sort goes through the
    kernel dispatch under hss_cfg.kernel_policy."""
    hss_cfg = hss_cfg or HSSConfig()
    ex_cfg = ex_cfg or ExchangeConfig(kernel_policy=hss_cfg.kernel_policy)
    local_sorted = dispatch.local_sort(local, policy=hss_cfg.kernel_policy)
    p, n_local = local.shape
    dev = local.device
    if p == 1:
        return SortResult(
            local_sorted,
            torch.full((1,), n_local, dtype=torch.int32, device=dev),
            torch.zeros((0,), dtype=local.dtype, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev), None)
    keys, ranks, stats = hss_splitters(
        local_sorted, comm=comm, cfg=hss_cfg, uniform=uniform,
        initial_probes=initial_probes)
    out, n_valid, ovf = exchange(local_sorted, keys, comm=comm, cfg=ex_cfg,
                                 eps=hss_cfg.eps)
    return SortResult(out, n_valid, keys, ranks, ovf, stats)
