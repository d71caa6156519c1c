"""Strided compare-exchange (K3), the HBM-resident bitonic merge pass, and
the merge-path pair merge (K5).

A bitonic merge of two sorted runs of length R is a fixed comparator
network: relayout the pair into one bitonic sequence (second run
reversed), then a half-cleaner cascade at distances R, R/2, ..., 1. K2
(`bitonic_merge_smem`) runs the whole network on chip while the
pair fits (2R <= SMEM_MAX_SEG). Above that, `merge_pass_hbm` splits the
same network into passes over device memory:

  strided_compare_exchange  K3, one cascade step at distance d, replacing
                            the Pallas `strided_compare_exchange`
                            (repro/kernels/merge/kernel.py:49);
  merge_bitonic_blocks      K2 without the reversal, replacing the Pallas
                            `merge_bitonic_blocks` (same file :71): once
                            2d <= SMEM_MAX_SEG, every remaining comparator
                            lies inside one aligned segment.

K3 is elementwise: one thread per pair (i, i+d), coalesced loads, 16-byte
vectors when d % 4 == 0. What bounds it is memory: 8 bytes read and 8
written per pair, no reuse, so its floor is 2 x bytes / 3.35 TB/s. The
reference's bitonic relayout (an XLA flip at merge/kernel.py:93-95, pure
data movement outside any kernel) would be one more full pass over the
array; here it is folded into the first K3 step (`flip=True` reads each
pair's partner mirrored), which saves that pass.

Both kernels write a new output; the plain version beside K3 is the
reference's `_strided_ce_kernel` in torch ops.

K5 (`merge_path_pairs`) merges the post-exchange runs instead
(kernels/merge/ops.merge_sorted_runs). It replaces no Pallas kernel: a
merge path cuts each pair merge into tiles that Hopper's blocks
run in any order, and reads and writes only each run's valid prefix, 8
bytes a key a level (16 for int64 keys, which K5 takes too), where the
network passes over every padded slot once a distance. `merge_path_pairs_plain` places each key by the same
arithmetic (its index plus its rank in the other run, ties to the first
run) with searchsorted and a scatter.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import hi_sentinel
from repro_torch.kernels import cuda
from repro_torch.kernels.bitonic_sort.kernel import (
    SMEM_MAX_SEG, bitonic_merge_smem)


def strided_compare_exchange_plain(x: torch.Tensor, d: int,
                                   flip: bool = False) -> torch.Tensor:
    rows, n = x.shape
    y = x.reshape(rows * n // (2 * d), 2, d)
    lo, hi = y[:, 0, :], y[:, 1, :]
    if flip:
        hi = hi.flip(-1)
    return torch.stack([torch.minimum(lo, hi), torch.maximum(lo, hi)],
                       dim=1).reshape(rows, n)


def strided_compare_exchange(x: torch.Tensor, d: int,
                             flip: bool = False) -> torch.Tensor:
    """K3: one ascending compare-exchange at distance `d` over each row of
    (rows, n): (x[i], x[i+d]) <- (min, max) for floor(i/d) even. With
    `flip`, the partner of x[i] is x[i + 2d - 1 - 2(i mod d)], i.e. the
    step runs on the relayout whose second d-run is reversed."""
    cuda.check_rows(x, "strided_compare_exchange")
    if d < 1 or d & (d - 1) or x.shape[1] % (2 * d):
        raise ValueError(f"strided_compare_exchange: distance {d} must be a "
                         f"power of two with 2d dividing {x.shape[1]}")
    if x.device.type == "cpu":
        return strided_compare_exchange_plain(x, d, flip)
    out = torch.empty_like(x)
    if x.numel():
        cuda.launch("strided_compare_exchange", x.dtype, x.data_ptr(),
                    out.data_ptr(), x.numel(), d, int(flip))
    return out


def merge_bitonic_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """Run the cascade at distances block/2 .. 1 within each aligned block."""
    return bitonic_merge_smem(x, block, reverse_second_half=False)


def merge_pass_hbm(x: torch.Tensor, run: int, *,
                   smem_block: int = SMEM_MAX_SEG) -> torch.Tensor:
    """Merge adjacent sorted runs of length `run` (a power of two) in each
    row into sorted runs of 2*run, holding at most `smem_block` keys on
    chip. Needs 2*run > smem_block (smaller pairs merge in one K2)."""
    if 2 * run <= smem_block:
        raise ValueError(f"run {run} fits on chip: use merge_adjacent")
    d, flip = run, True
    while 2 * d > smem_block:
        x = strided_compare_exchange(x, d, flip=flip)
        d, flip = d // 2, False
    return merge_bitonic_blocks(x, 2 * d)


def _merge_path_args(x: torch.Tensor, counts, out_len):
    cuda.check_keys(x, "merge_path_pairs")
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"merge_path_pairs: expected non-empty (rows, k, "
                         f"stride), got {tuple(x.shape)}")
    if counts is not None and (counts.dtype != torch.int32
                               or counts.shape != x.shape[:2]
                               or counts.device != x.device):
        raise ValueError(f"merge_path_pairs: counts must be int32 of shape "
                         f"{tuple(x.shape[:2])} on {x.device}, got "
                         f"{counts.dtype} {tuple(counts.shape)} on "
                         f"{counts.device}")
    length = 2 * x.shape[2] if out_len is None else out_len
    if length < 1:
        raise ValueError(f"merge_path_pairs: out_len {out_len} must be >= 1")
    return length


def merge_path_pairs_plain(x: torch.Tensor,
                           counts: torch.Tensor | None = None,
                           out_len: int | None = None):
    """K5's plain version: run 2j merged with run 2j+1 of each row. A key
    of run 2j lands at its index plus the count of run 2j+1's keys below
    it; a key of run 2j+1 at its index plus the count of run 2j's keys at
    or below it. Slots past the merged keys hold the hi sentinel."""
    length = _merge_path_args(x, counts, out_len)
    rows, k, stride = x.shape
    sent = hi_sentinel(x.dtype)
    c = (torch.full((rows, k), stride, dtype=torch.int32, device=x.device)
         if counts is None else counts.clamp(0, stride))
    if k % 2:
        x = torch.cat([x, torch.full((rows, 1, stride), sent, dtype=x.dtype,
                                     device=x.device)], dim=1)
        c = torch.cat([c, c.new_zeros((rows, 1))], dim=1)
    pos = torch.arange(stride, device=x.device)
    ca, cb = c[:, 0::2, None], c[:, 1::2, None]
    a = torch.where(pos < ca, x[:, 0::2], sent).contiguous()
    b = torch.where(pos < cb, x[:, 1::2], sent).contiguous()
    # past a run's count its slots read as the sentinel, which no key is
    # below; a sentinel key of run 2j+1 counts only run 2j's keys
    to_a = pos + torch.searchsorted(b, a, side="left")
    to_b = pos + torch.minimum(torch.searchsorted(a, b, side="right"), ca)
    out = torch.full((rows, a.shape[1], length + 1), sent, dtype=x.dtype,
                     device=x.device)
    for keys, to, n in ((a, to_a, ca), (b, to_b, cb)):
        to = torch.where((pos < n) & (to < length), to, length)
        out.scatter_(-1, to, keys)
    merged = torch.clamp(ca + cb, max=length)[..., 0].to(torch.int32)
    return out[..., :length], merged


def merge_path_pairs(x: torch.Tensor, counts: torch.Tensor | None = None,
                     out_len: int | None = None, *, _fill: bool = True):
    """K5: merge run 2j with run 2j+1 of each row of (rows, k, stride)
    sorted int32 or int64 runs -> (out (rows, ceil(k/2), L), merged
    (rows, ceil(k/2)) int32). Run i's keys are its first counts[:, i]
    slots (the whole stride when counts is None); an odd last run merges
    with an empty one; L is out_len (default 2 * stride), and each output
    run is its first L merged keys, then the hi sentinel; merged counts
    them, min(count sum, L). So at k <= 2, with every slot past a count
    holding the sentinel, the output is `cap_to(sort(row), out_len)`.

    `_fill=False` is merge_sorted_runs' inner levels alone: the kernel
    leaves each output run's slots past its merged count unwritten, since
    the next level reads only the counts' prefixes."""
    length = _merge_path_args(x, counts, out_len)
    if x.device.type == "cpu":
        return merge_path_pairs_plain(x, counts, out_len)
    if not x.is_contiguous() or (counts is not None
                                 and not counts.is_contiguous()):
        raise ValueError("merge_path_pairs: CUDA inputs must be contiguous")
    rows, k, stride = x.shape
    out = torch.empty((rows, (k + 1) // 2, length), dtype=x.dtype,
                      device=x.device)
    merged = torch.empty((rows, (k + 1) // 2), dtype=torch.int32,
                         device=x.device)
    cuda.launch("merge_path_pairs", x.dtype, x.data_ptr(),
                None if counts is None else counts.data_ptr(),
                out.data_ptr(), merged.data_ptr(), rows, k, stride, length,
                int(_fill))
    return out, merged
