"""HSS-based global length bucketing (counterpart of repro.data.partition).

Packing variable-length documents into fixed-length training sequences
wastes pad tokens unless documents of similar size are batched together.
A global sort of (length, doc_id) keys over the data loader's shards is
exactly the paper's problem: the HSS splitters give every shard a
near-equal, contiguous length range. `bucket_lengths` runs the port's
sort front door (`repro_torch.sort.sort`, so its kernels on the card);
duplicate tagging (lengths repeat heavily) and doc-id tracking are the
adapter layer's job, so this module is only the bucketing policy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sort import SortSpec, sort


def bucket_lengths(lengths: np.ndarray, n_shards: int, eps: float = 0.05,
                   seed: int = 0, spec: SortSpec | None = None):
    """Partition docs into n_shards contiguous-length buckets via HSS.

    Returns (doc_ids_per_shard: list[np.ndarray], counts). Each shard's
    docs are no longer than the next shard's (a globally balanced order),
    so per-shard packing sees near-homogeneous lengths. The sort is stable
    over `n_shards` shards with the allgather exchange (the reference's
    default); pass `spec` to choose the configuration and the device (the
    default spec runs on the card), of which the shard count, the seed and
    stability are set here. Repeated calls of one queue size and shard
    count are hits of one cache key (`repro_torch.sort.exec_cache`).
    """
    spec = dataclasses.replace(
        spec or SortSpec(algorithm="hss", eps=eps, exchange="allgather"),
        seed=seed, shards=n_shards, stable=True)
    out = sort(lengths, spec)
    counts = out.counts.cpu().numpy()
    indices = out.indices.cpu().numpy()
    ids = [indices[i, :counts[i]] for i in range(n_shards)]
    return ids, counts


def pack_documents(doc_ids: np.ndarray, lengths: np.ndarray, seq_len: int):
    """First-fit packing of (already length-sorted) docs into sequences.

    Returns a list of lists of doc ids; the padding fraction is the bench
    metric.
    """
    seqs, cur, cur_len = [], [], 0
    for d in doc_ids:
        ln = int(lengths[d])
        if cur_len + ln > seq_len and cur:
            seqs.append(cur)
            cur, cur_len = [], 0
        cur.append(int(d))
        cur_len += ln
    if cur:
        seqs.append(cur)
    return seqs


def padding_fraction(seqs, lengths, seq_len: int) -> float:
    used = sum(min(sum(int(lengths[d]) for d in s), seq_len) for s in seqs)
    return 1.0 - used / (len(seqs) * seq_len)
