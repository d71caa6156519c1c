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
    out = sort(x, verify="cheap")      # fused audit: out.audit
    out = sort(x, imbalance_slo=1.2)   # partition-quality SLO

Grouping (repro_torch.sort.semisort): `semisort(keys)` makes equal keys
contiguous with heavy hitters reported as exact (key, count) groups,
`groupby_aggregate(keys, values, op=...)` aggregates per distinct key and
`top_k(keys, k)` prunes on each shard before one all_gather.

The shared host driver lives in repro_torch.sort.driver, the dtype and
duplicate adapters in repro_torch.sort.adapters, the partitioner registry
in repro_torch.sort.partitioners, the audit in repro_torch.sort.verify and
the MoE dispatch helpers in repro_torch.sort.grouping. The front doors
record each launch in `exec_cache`, keyed by `spec_fingerprint`'s fields
and the shape; `bucket_key` is the serving layer's grouping key.
"""
from repro_torch.sort.adapters import BatchedSortOutput, SortOutput
from repro_torch.sort.api import (
    RecoveryStats, argsort, bucket_key, gather, gather_perm_checked, sort,
    sort_batched, sort_kv, spec_fingerprint)
from repro_torch.sort.driver import exec_cache
from repro_torch.sort.grouping import group_by_length
from repro_torch.sort.partitioners import (
    Partitioner, ShardCtx, available_algorithms, get_partitioner,
    register_partitioner)
from repro_torch.sort.semisort import (
    GROUPBY_OPS, BatchedSemisortOutput, SemisortOutput, groupby_aggregate,
    semisort, semisort_batched, top_k, top_k_batched)
from repro_torch.sort.spec import (
    ALGORITHMS, ON_OVERFLOW, ON_VERIFY_FAILURE, VERIFY, SortSpec)
from repro_torch.sort.verify import (
    AuditReport, BatchVerificationError, ImbalanceError, VerificationError)

__all__ = [
    "ALGORITHMS", "AuditReport", "BatchVerificationError",
    "BatchedSemisortOutput", "BatchedSortOutput", "GROUPBY_OPS",
    "ImbalanceError", "ON_OVERFLOW", "ON_VERIFY_FAILURE", "Partitioner",
    "RecoveryStats", "SemisortOutput", "ShardCtx", "SortOutput", "SortSpec",
    "VERIFY", "VerificationError", "argsort", "available_algorithms",
    "bucket_key", "exec_cache", "gather", "gather_perm_checked",
    "get_partitioner", "group_by_length", "groupby_aggregate",
    "register_partitioner", "semisort", "semisort_batched", "sort",
    "sort_batched", "sort_kv", "spec_fingerprint", "top_k",
    "top_k_batched",
]
