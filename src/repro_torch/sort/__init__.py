"""repro_torch.sort — the port's sort front door.

    from repro_torch.sort import SortSpec, sort, sort_batched
    out = sort(x, SortSpec(shards=8, eps=0.05))
    np_sorted = out.gather()
    outs = sort_batched(xs)            # (B, n): B requests, one pipeline
    outs.gather(b)

The shared host driver lives in repro_torch.sort.driver, the dtype and
duplicate adapters in repro_torch.sort.adapters, the partitioner registry
in repro_torch.sort.partitioners.
"""
from repro_torch.sort.adapters import BatchedSortOutput, SortOutput
from repro_torch.sort.api import gather, sort, sort_batched
from repro_torch.sort.grouping import group_by_length
from repro_torch.sort.partitioners import (
    Partitioner, ShardCtx, available_algorithms, get_partitioner,
    register_partitioner)
from repro_torch.sort.spec import ALGORITHMS, ON_OVERFLOW, SortSpec

__all__ = [
    "ALGORITHMS", "BatchedSortOutput", "ON_OVERFLOW", "Partitioner",
    "ShardCtx", "SortOutput", "SortSpec", "available_algorithms", "gather",
    "get_partitioner", "group_by_length", "register_partitioner", "sort",
    "sort_batched",
]
