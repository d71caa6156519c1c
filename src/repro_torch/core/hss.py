"""End-to-end Histogram Sort with Sampling over emulated shards.

Counterpart of `repro.core.hss`. `hss_sort_sharded` is the shard-level
pipeline — local sort, splitter determination, exchange — over a
(p, n_local) tensor whose rows are the shards.

    from repro_torch.core import hss
    result = hss.hss_sort(x)                  # 1-D int32 keys, 8 shards
    keys = hss.gather_sorted(result)          # flat sorted NumPy array

`hss_sort` and the other legacy entry points (`sample_sort`, `ams_sort`,
`two_stage_sort`) are shims over the shared driver,
`repro_torch.sort.driver.run_batched` at B = 1 (DESIGN.md Section 3.2),
as the reference's are over its `run`. Each takes `shards` and `device`
("cuda" by default; no card raises) where the reference takes a mesh,
and `uniform` to inject the draws as `repro_torch.sort.sort` does. Keys
go to the core as they are: int32 (the kernels' contract) or int64 (the
torch route); new code should call `repro_torch.sort.sort`, which maps
every key type onto them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.common import HSSConfig
from repro_torch.core.exchange import (
    ExchangeConfig, exchange, exchange_batched)
from repro_torch.core.splitters import (
    SplitterStats, Uniform, hss_splitters, hss_splitters_batched)
from repro_torch.kernels import dispatch
from repro_torch.parallel.comm import Comm
from repro_torch.runtime.syncs import to_device


class SortResult(NamedTuple):
    shards: torch.Tensor          # (p, out_cap) sorted, sentinel-padded
    counts: torch.Tensor          # (p,) valid keys per shard
    splitter_keys: torch.Tensor   # (p-1,)
    splitter_ranks: torch.Tensor  # (p-1,)
    overflow: torch.Tensor        # dropped keys (0 => exact)
    stats: SplitterStats | None


def _driver(sort_fn, x, *, shards: int, seed: int, device, uniform,
            local_sort_fn) -> SortResult:
    """The legacy entry points' shim over the shared driver (counterpart
    of core/hss.py:60-72): x (n,) through `driver.run_batched` at B = 1,
    uncached as the reference's is (its `_driver` passes no cache key),
    the batch axis squeezed back out. `sort_fn(rows, comm, draws)` is a
    batched shard program over (p, 1, n_local) rows."""
    from repro_torch.sort import driver
    from repro_torch.sort.adapters import as_keys
    from repro_torch.sort.api import resolve_device

    xs = as_keys(x, resolve_device(device))
    if xs.dim() != 1:
        raise ValueError(f"expected a 1-D key array, got {tuple(xs.shape)}")
    out, counts, keys, ranks, ovf, stats = driver.run_batched(
        driver.shard_program(None, lambda: sort_fn, shards), xs[None],
        p=shards, seed=seed, local_sort_fn=local_sort_fn, uniform=uniform)
    if stats is not None:
        stats = type(stats)(*(f[..., 0] for f in stats))
    return SortResult(out[0], counts[0], keys[0], ranks[0], ovf[0], stats)


def hss_sort(x, shards: int = 8, hss_cfg: HSSConfig | None = None,
             ex_cfg: ExchangeConfig | None = None, seed: int = 0,
             initial_probes=None, local_sort_fn=None, *, device="cuda",
             uniform=None) -> SortResult:
    """Sort a 1-D array over `shards` emulated shards (counterpart of
    core/hss.py:84). Returns the SortResult of (p, ...) shard tensors;
    `gather_sorted` flattens it. `uniform` takes (j, n) -> (p, n) draws,
    one split a round as the partitioner numbers them."""
    hss_cfg = hss_cfg or HSSConfig()
    ex_cfg = ex_cfg or ExchangeConfig(kernel_policy=hss_cfg.kernel_policy)
    sort_rows = local_sort_fn or dispatch.local_sort_fn(hss_cfg.kernel_policy)

    def sort_fn(rows, comm, draws):
        local_sorted = sort_rows(rows)
        n_local = rows.shape[-1]
        probes = (None if initial_probes is None else to_device(
            initial_probes, rows.dtype, rows.device)[None])
        keys, ranks, stats = hss_splitters_batched(
            local_sorted, comm=comm, cfg=hss_cfg,
            uniform=lambda j: draws(j, n_local), initial_probes=probes)
        out, n_valid, ovf = exchange_batched(
            local_sorted, keys, comm=comm, cfg=ex_cfg, eps=hss_cfg.eps)
        return out, n_valid, keys, ranks, ovf, stats

    return _driver(sort_fn, x, shards=shards, seed=seed, device=device,
                   uniform=uniform, local_sort_fn=sort_rows)


def gather_sorted(result: SortResult):
    """Concatenate the valid prefixes of all shards as one NumPy array
    (counterpart of core/hss.py:109): one masked select on the device."""
    from repro_torch.sort.driver import masked_concat
    return masked_concat(result.shards, result.counts)


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
