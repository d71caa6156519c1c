"""repro_torch.sort — the port's sort front door.

    from repro_torch.sort import SortSpec, argsort, sort, sort_batched
    out = sort(x, SortSpec(shards=8, eps=0.05))
    np_sorted = out.gather()
    outs = sort_batched(xs)            # (B, n): B requests, one pipeline
    outs.gather(b)
    order = argsort(x)                 # stable permutation, NumPy
    keys, vals = sort_kv(keys, vals)   # payloads ride along
    out = sort(x, on_overflow="retry") # exact; out.recovery says how
    out = sort(x, algorithm="multistage")  # see available_algorithms()
    out = sort(x, exchange="ragged")   # the exact alltoallv

The shared host driver lives in repro_torch.sort.driver, the dtype and
duplicate adapters in repro_torch.sort.adapters, the partitioner registry
in repro_torch.sort.partitioners.
"""
from repro_torch.sort.adapters import BatchedSortOutput, SortOutput
from repro_torch.sort.api import (
    RecoveryStats, argsort, gather, gather_perm_checked, sort, sort_batched,
    sort_kv)
from repro_torch.sort.grouping import group_by_length
from repro_torch.sort.partitioners import (
    Partitioner, ShardCtx, available_algorithms, get_partitioner,
    register_partitioner)
from repro_torch.sort.spec import ALGORITHMS, ON_OVERFLOW, SortSpec

__all__ = [
    "ALGORITHMS", "BatchedSortOutput", "ON_OVERFLOW", "Partitioner",
    "RecoveryStats", "ShardCtx", "SortOutput", "SortSpec", "argsort",
    "available_algorithms", "gather", "gather_perm_checked",
    "get_partitioner", "group_by_length", "register_partitioner", "sort",
    "sort_batched", "sort_kv",
]
