"""repro_torch — Histogram Sort with Sampling on PyTorch and CUDA.

The port of the JAX package `repro` to one NVIDIA H100. The p shards of a
distributed sort are the leading axis of one tensor on one device; the
collectives between them are tensor ops behind one seam
(`repro_torch.parallel.comm.Comm`). Every Pallas kernel on the sort's path
has a hand-written CUDA counterpart under `repro_torch/kernels/csrc`, and a
plain PyTorch version beside it that the CPU runs.

    from repro_torch.sort import SortSpec, sort, sort_batched
    from repro_torch import argsort, sort_kv
    out = sort(x, SortSpec(shards=8))           # on the card by default
    out.gather()                                # flat sorted NumPy array
    outs = sort_batched(xs)                     # (B, n): B requests at once
    order = argsort(x)                          # stable permutation
    keys, vals = sort_kv(keys, vals)            # payloads ride along
    sort(x, SortSpec(algorithm="ams"))          # available_algorithms()
    sort(x, SortSpec(exchange="ragged"))        # the exact alltoallv

Subpackages mirror `repro`: core/ (splitters, exchange, hss, sample_sort,
ams, multistage), kernels/ (bitonic_sort, merge, histogram, dispatch),
sort/ (spec, partitioners, driver, adapters, grouping, api, verify,
semisort), data/ (the paper's input distributions), parallel/ (the Comm
seam), runtime/ (chaos). Nothing here imports jax or repro. The package
exports the permutation and grouping front doors, the audit's names and
`available_algorithms`; `sort` itself stays the subpackage's name
(`repro_torch.sort`), so it is not re-exported here.
"""
from repro_torch.sort.api import (
    RecoveryStats, argsort, gather_perm_checked, sort_kv)
from repro_torch.sort.partitioners import available_algorithms
from repro_torch.sort.semisort import (
    GROUPBY_OPS, BatchedSemisortOutput, SemisortOutput, groupby_aggregate,
    semisort, semisort_batched, top_k, top_k_batched)
from repro_torch.sort.spec import ON_VERIFY_FAILURE, VERIFY
from repro_torch.sort.verify import (
    AuditReport, BatchVerificationError, ImbalanceError, VerificationError)

__all__ = ["AuditReport", "BatchVerificationError", "BatchedSemisortOutput",
           "GROUPBY_OPS", "ImbalanceError", "ON_VERIFY_FAILURE",
           "RecoveryStats", "SemisortOutput", "VERIFY", "VerificationError",
           "argsort", "available_algorithms", "gather_perm_checked",
           "groupby_aggregate", "semisort", "semisort_batched", "sort_kv",
           "top_k", "top_k_batched"]
