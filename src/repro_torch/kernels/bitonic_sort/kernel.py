"""Bitonic block sort (K1) and shared-memory bitonic merge (K2).

K1 `sort_blocks` replaces the Pallas `sort_blocks`
(repro/kernels/bitonic_sort/kernel.py:83): it sorts each contiguous
`block`-key run of every row. K2 `bitonic_merge_smem` replaces both
`merge_adjacent` (same file :117; reverse_second_half=True) and the merge
package's `merge_bitonic_blocks` (repro/kernels/merge/kernel.py:71;
reverse_second_half=False).

What bounds them on an H100: bytes. Each kernel reads every key once and
writes it once (K1 at block 1024 does 55 comparators per key pair, about
1 GOP for the (8, 2^21) shard rows, against 128 MiB of traffic; the card's
3.35 TB/s moves that in 40 us, its int32 rate does the comparators in
28 us). The design keeps every network step out of device memory: one
thread block holds its run (K1: at most 1024 keys, 4 KB) or segment (K2:
at most SMEM_MAX_SEG = 16,384 keys, 64 KB of dynamic shared memory) in
shared memory, each thread does one comparator per step, and
__syncthreads() separates the steps. The TPU kernel's VMEM limit (pairs
of MAX_RUN = 65,536 keys, 256 KiB) does not fit a Hopper block's 227 KB,
so the merge cascade switches to the strided HBM pass (K3) above
SMEM_MAX_SEG instead; the comparators are the same, so the output is
bit-identical whatever the threshold.

Beside each wrapper is its plain PyTorch version: the reference's network
(`_compare_exchange`, bitonic_sort/kernel.py:23) in torch ops. A wrapper
runs the plain version only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

#: Largest segment (keys) K2 holds in shared memory: 64 KB of int32.
SMEM_MAX_SEG = 16384
#: Largest run K1 sorts in one thread block (its threads do one pair each).
MAX_BLOCK = 1024


def _compare_exchange(x: torch.Tensor, d: int, k: int) -> torch.Tensor:
    """One network step over the last axis: sort pairs (i, i+d) ascending
    iff (i & k) == 0."""
    *lead, b = x.shape
    y = x.reshape(*lead, b // (2 * d), 2, d)
    lo, hi = y[..., 0, :], y[..., 1, :]
    mn = torch.minimum(lo, hi)
    mx = torch.maximum(lo, hi)
    row = torch.arange(b // (2 * d), device=x.device)[:, None]
    asc = ((row * (2 * d)) & k) == 0
    new_lo = torch.where(asc, mn, mx)
    new_hi = torch.where(asc, mx, mn)
    return torch.stack([new_lo, new_hi], dim=-2).reshape(*lead, b)


def bitonic_sort_network(x: torch.Tensor) -> torch.Tensor:
    """Full bitonic sort of the (power-of-two) last axis."""
    b = x.shape[-1]
    log_b = b.bit_length() - 1
    if 1 << log_b != b:
        raise ValueError(f"block size {b} must be a power of two")
    for m in range(log_b):
        k = 1 << (m + 1)
        for d_exp in range(m, -1, -1):
            x = _compare_exchange(x, 1 << d_exp, k)
    return x


def bitonic_merge_network(x: torch.Tensor) -> torch.Tensor:
    """Merge a bitonic last axis (two sorted halves, second reversed)."""
    b = x.shape[-1]
    log_b = b.bit_length() - 1
    if 1 << log_b != b:
        raise ValueError(f"segment size {b} must be a power of two")
    for d_exp in range(log_b - 1, -1, -1):
        # k larger than b => every pair ascending
        x = _compare_exchange(x, 1 << d_exp, 2 * b)
    return x


def sort_blocks_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    rows, n = x.shape
    return bitonic_sort_network(x.reshape(rows, n // block, block)
                                ).reshape(rows, n)


def bitonic_merge_plain(x: torch.Tensor, seg: int,
                        reverse_second_half: bool) -> torch.Tensor:
    rows, n = x.shape
    y = x.reshape(rows, n // seg, seg)
    if reverse_second_half:
        half = seg // 2
        y = torch.cat([y[..., :half], y[..., half:].flip(-1)], dim=-1)
    return bitonic_merge_network(y).reshape(rows, n)


def _check_pow2_run(x: torch.Tensor, run: int, limit: int, what: str):
    cuda.check_int32_rows(x, what)
    if run < 2 or run & (run - 1) or run > limit:
        raise ValueError(f"{what}: run {run} must be a power of two in "
                         f"[2, {limit}]")
    if x.shape[1] % run:
        raise ValueError(f"{what}: row length {x.shape[1]} is not a "
                         f"multiple of {run}")


def sort_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """K1: sort each contiguous `block`-key run of each row of (rows, n)."""
    _check_pow2_run(x, block, MAX_BLOCK, "sort_blocks")
    if x.device.type == "cpu":
        return sort_blocks_plain(x, block)
    out = torch.empty_like(x)
    if x.numel():
        cuda.launch("bitonic_sort_blocks", x.data_ptr(), out.data_ptr(),
                    x.numel(), block)
    return out


def bitonic_merge_smem(x: torch.Tensor, seg: int,
                       reverse_second_half: bool) -> torch.Tensor:
    """K2: half-cleaner cascade seg/2..1 inside each aligned `seg`-key
    segment of each row, after reversing each segment's second half when
    `reverse_second_half` (two sorted runs -> one sorted run)."""
    _check_pow2_run(x, seg, SMEM_MAX_SEG, "bitonic_merge_smem")
    if x.device.type == "cpu":
        return bitonic_merge_plain(x, seg, reverse_second_half)
    out = torch.empty_like(x)
    if x.numel():
        role = "reverse" if reverse_second_half else "tail"
        cuda.launch("bitonic_merge_smem", x.data_ptr(), out.data_ptr(),
                    x.numel(), seg, int(reverse_second_half),
                    counter=f"bitonic_merge_smem.{role}")
    return out


def merge_adjacent(x: torch.Tensor, run: int) -> torch.Tensor:
    """Merge adjacent sorted runs of length `run` into runs of 2*run."""
    return bitonic_merge_smem(x, 2 * run, reverse_second_half=True)
