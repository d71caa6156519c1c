"""Bitonic block sort (K1) and the register-and-shuffle bitonic merge (K2).

K1 `sort_blocks` replaces the Pallas `sort_blocks`
(repro/kernels/bitonic_sort/kernel.py:83) and `sort_blocks_batched` (:98):
it sorts each contiguous `block`-key run of every row. K2
`bitonic_merge_smem` replaces both `merge_adjacent` (same file :117;
reverse_second_half=True) and the merge package's `merge_bitonic_blocks`
(repro/kernels/merge/kernel.py:71; reverse_second_half=False).

What bounds them on an H100: bytes. Each kernel reads every key once and
writes it once (K1 at block 1024 does 55 comparators per key pair, about
1 GOP for the (8, 2^21) shard rows, against 128 MiB of traffic; the card's
3.35 TB/s moves that in 40 us, its int32 rate does the comparators in
28 us).

K1 keeps a block of at most MAX_BLOCK = 1,024 keys in one warp's
registers, min(32, block) consecutive keys a thread, so that the low bits
of the key index, which the network steps most often, are register bits
and the high ones lane bits. Each stage opens with a mirror step (key i
against i ^ (2^(m+1) - 1)) and goes on with ascending half-cleaners, so no
step needs a direction. `sort_blocks_tiled_plain` is that schedule in
torch ops; sort_kernels.cu says why.

K2 keeps a segment of at most SMEM_MAX_SEG = 16,384 keys in registers,
32 keys a thread (fewer below 1,024 keys), and runs each half-cleaner step
where the step's bit of the key index lies: a register bit is a min/max of
two registers, a lane bit a warp shuffle; a segment above 1,024 keys
changes layout once through shared memory (64 KB at 16,384) so that every
step is one or the other. `bitonic_merge_tiled_plain` is that schedule in
torch ops (the layouts, the register steps as reshapes, the shuffles as
the xor pairing, the change of layout as a permute), for the CPU tests;
sort_kernels.cu says why. The TPU kernel's VMEM limit (pairs of MAX_RUN =
65,536 keys, 256 KiB) does not fit an SM, so the merge cascade switches to
the strided HBM pass (K3) above SMEM_MAX_SEG instead; the comparators are
the same, so the output is bit-identical whatever the threshold.

Beside each wrapper is its plain PyTorch version: the reference's network
(`_compare_exchange`, bitonic_sort/kernel.py:23) in torch ops. A wrapper
runs the plain version only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

#: Largest segment (keys) K2 merges on chip: 64 KB of int32.
SMEM_MAX_SEG = 16384
#: Keys a K2 thread holds in registers for segments above 1,024 keys.
MERGE_KEYS = 32
#: Largest run K1 sorts: one warp's registers, 32 keys a thread.
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


def merge_layout(seg: int) -> tuple[int, int]:
    """K2's layout A for a `seg`-key segment: (K, T), K keys in registers
    for each of T threads, key r*T + t in register r of thread t."""
    keys = MERGE_KEYS if seg > 1024 else (seg // 32 if seg >= 64 else 2)
    return keys, seg // keys


def _register_steps(a: torch.Tensor, bits) -> torch.Tensor:
    """Half-cleaner steps on register bits `bits` (high to low) of a
    (..., K, T) layout: registers r and r | 2^b, the lower takes the min."""
    *lead, k, t = a.shape
    for b in bits:
        y = a.reshape(*lead, k >> (b + 1), 2, 1 << b, t)
        lo, hi = y[..., 0, :, :], y[..., 1, :, :]
        a = torch.stack([torch.minimum(lo, hi), torch.maximum(lo, hi)],
                        dim=-3).reshape(*lead, k, t)
    return a


def _lane_steps(a: torch.Tensor, bits) -> torch.Tensor:
    """Half-cleaner steps on lane bits `bits` (high to low) of a (..., K, T)
    layout: each thread takes the same register of thread t ^ 2^b (the
    shuffle) and keeps the max if its bit b is set, else the min."""
    lane = torch.arange(a.shape[-1], device=a.device)
    for b in bits:
        partner = a[..., lane ^ (1 << b)]
        upper = ((lane >> b) & 1).bool()
        a = torch.where(upper, torch.maximum(a, partner),
                        torch.minimum(a, partner))
    return a


def bitonic_merge_tiled_plain(x: torch.Tensor, seg: int,
                              reverse_second_half: bool) -> torch.Tensor:
    """K2's schedule in torch ops: the same function as
    `bitonic_merge_plain`, step by step through the kernel's layouts."""
    rows, n = x.shape
    y = x.reshape(rows * n // seg, seg)
    if reverse_second_half:         # the load reads the second half mirrored
        half = seg // 2
        y = torch.cat([y[:, :half], y[:, half:].flip(-1)], dim=-1)
    k, t = merge_layout(seg)
    log_k = k.bit_length() - 1
    a = _register_steps(y.reshape(-1, k, t), range(log_k - 1, -1, -1))
    if seg <= 1024:                 # one layout: the rest are lane bits
        a = _lane_steps(a, range(t.bit_length() - 2, -1, -1))
        return a.reshape(rows, n)
    # layout B, key w*32K + r*32 + l in register r of lane l of warp w:
    # the keys in segment order, split (w, r, l), permuted to (r, w, l)
    warps = t // 32
    a = a.reshape(-1, warps, k, 32).permute(0, 2, 1, 3).reshape(-1, k, t)
    log_seg = seg.bit_length() - 1
    a = _register_steps(a, range(log_seg - 11, -1, -1))  # key bits L-6..5
    a = _lane_steps(a, range(4, -1, -1))                   # key bits 4..0
    return a.reshape(-1, k, warps, 32).permute(0, 2, 1, 3).reshape(rows, n)


def _register_mirror(a: torch.Tensor, m: int) -> torch.Tensor:
    """A stage's first step on register bits m..0 of a (..., K, T) layout:
    register r against its mirror r ^ (2^(m+1) - 1), the lower takes the
    min."""
    *lead, k, t = a.shape
    y = a.reshape(*lead, k >> (m + 1), 2, 1 << m, t)
    lo, hi = y[..., 0, :, :], y[..., 1, :, :].flip(-2)
    return torch.stack([torch.minimum(lo, hi), torch.maximum(lo, hi).flip(-2)],
                       dim=-3).reshape(*lead, k, t)


def _lane_mirror(a: torch.Tensor, b: int) -> torch.Tensor:
    """A stage's first step whose top bit is lane bit b: lane l against lane
    l ^ (2^(b+1) - 1), register r against the partner's register K-1-r (the
    shuffle of the mirrored register); the lane whose bit b is set keeps
    the max."""
    lane = torch.arange(a.shape[-1], device=a.device)
    partner = a[..., lane ^ ((2 << b) - 1)].flip(-2)
    upper = ((lane >> b) & 1).bool()
    return torch.where(upper, torch.maximum(a, partner),
                       torch.minimum(a, partner))


def sort_blocks_tiled_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """K1's schedule in torch ops: the same function as `sort_blocks_plain`,
    stage by stage through the kernel's layout."""
    rows, n = x.shape
    k = min(32, block)         # keys a lane: key l*K + r in register r
    t = block // k             # lanes a block
    log_k = k.bit_length() - 1
    # the change of layout through shared memory: lane l's K consecutive
    # keys, held as (..., K, T) for the register and lane steps
    a = x.reshape(-1, t, k).transpose(-1, -2)
    for m in range(block.bit_length() - 1):
        if m < log_k:
            a = _register_mirror(a, m)
            a = _register_steps(a, range(m - 1, -1, -1))
        else:
            a = _lane_mirror(a, m - log_k)
            a = _lane_steps(a, range(m - log_k - 1, -1, -1))
            a = _register_steps(a, range(log_k - 1, -1, -1))
    return a.transpose(-1, -2).reshape(rows, n)


def _check_pow2_run(x: torch.Tensor, run: int, limit: int, what: str,
                    kernel: str | None = None):
    cuda.check_rows(x, what, kernel)
    if run < 2 or run & (run - 1) or run > limit:
        raise ValueError(f"{what}: run {run} must be a power of two in "
                         f"[2, {limit}]")
    if x.shape[1] % run:
        raise ValueError(f"{what}: row length {x.shape[1]} is not a "
                         f"multiple of {run}")


def sort_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """K1: sort each contiguous `block`-key run of each row of (rows, n)."""
    _check_pow2_run(x, block, MAX_BLOCK, "sort_blocks", "bitonic_sort_blocks")
    if x.device.type == "cpu":
        return sort_blocks_plain(x, block)
    out = torch.empty_like(x)
    if x.numel():
        cuda.launch("bitonic_sort_blocks", x.dtype, x.data_ptr(),
                    out.data_ptr(), x.numel(), block)
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
        cuda.launch("bitonic_merge_smem", x.dtype, x.data_ptr(),
                    out.data_ptr(), x.numel(), seg, int(reverse_second_half),
                    role="reverse" if reverse_second_half else "tail")
    return out


def merge_adjacent(x: torch.Tensor, run: int) -> torch.Tensor:
    """Merge adjacent sorted runs of length `run` into runs of 2*run."""
    return bitonic_merge_smem(x, 2 * run, reverse_second_half=True)
