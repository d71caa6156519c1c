"""K7: the dense exchange's send buffer, as one batched copy.

Row (s, b) of keys (S, B, n) is shard s of request b, sorted ascending.
starts and counts (S, B, S) int32 say where destination d's slice of that
row begins and how many of its keys go; the exchange has cut each count at
the pair's capacity `cap`. Run (s, d, b) of the buffer (S, S, B, cap), in
all_to_all's layout, holds keys[s, b, starts + j] in slot j < count and
the hi sentinel after it.

K7 (`dense_send`, csrc/sort_kernels.cu) replaces no Pallas kernel: the
reference cuts and pads the slices in XLA. What bounds it is bytes: one
read of the keys that go and one write of the buffer, 1.28 ms for 2^28
int32 keys into (8, 8, 1, 12,582,912) slots at 3.35 TB/s (2.56 ms at
int64). A block owns 16 KB of one run and writes it in 16-byte stores;
slots past the count load nothing. One launch, no host read: the grid is
the buffer's static shape.

`dense_send_plain` computes the same function in torch ops, and is the
torch route of `kernels.dispatch.dense_send` too: it builds the flat int64
gather index of every slot, clamped to its row's end as the kernel clamps
it, gathers through it and writes the sentinel past each count; at the
benchmark's (8, 1, 2^25) rows an index of 805 M entries.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import hi_sentinel
from repro_torch.kernels import cuda


def _check_args(keys, starts, counts, cap):
    what = "dense_send"
    cuda.check_keys(keys, what)
    if keys.dim() != 3:
        raise ValueError(f"{what}: expected (shards, batch, n) keys, got "
                         f"{tuple(keys.shape)}")
    shards, batch, n = keys.shape
    want = (shards, batch, shards)
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or tuple(t.shape) != want:
            raise TypeError(f"{what}: {name} must be int32 of shape {want}, "
                            f"got {t.dtype} {tuple(t.shape)}")
        if t.device != keys.device:
            raise ValueError(f"{what}: {name} must be on {keys.device}")
    if cap < 0 or (cap and not n):
        raise ValueError(f"{what}: cap {cap} of rows of {n} keys")
    if keys.device.type == "cuda" and not all(
            t.is_contiguous() for t in (keys, starts, counts)):
        raise ValueError(f"{what}: CUDA inputs must be contiguous")


def dense_send_plain(keys, starts, counts, cap):
    """K7's plain version; the arguments and result of `dense_send`."""
    shards, batch, n = keys.shape
    dev = keys.device
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    row = torch.arange(shards * batch, dtype=torch.int64,
                       device=dev).reshape(shards, 1, batch, 1) * n
    idx = row + torch.clamp(
        starts.permute(0, 2, 1).to(torch.int64)[..., None] + pos,
        max=n - 1)                                     # (S, S, B, cap)
    vals = keys.reshape(-1)[idx]
    del idx
    return torch.where(pos < counts.permute(0, 2, 1)[..., None], vals,
                       hi_sentinel(keys.dtype))


def dense_send(keys: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor, cap: int) -> torch.Tensor:
    """K7: keys (S, B, n) int32 or int64, each row sorted; starts and
    counts (S, B, S) int32, destination d's slice of row (s, b) and the
    number of its keys that go -> buf (S, S, B, cap): run (s, d, b) holds
    keys[s, b, starts[s, b, d] + j] for j < counts[s, b, d] (the read
    index clamped to the row's end), then the hi sentinel."""
    _check_args(keys, starts, counts, cap)
    if keys.device.type == "cpu":
        return dense_send_plain(keys, starts, counts, cap)
    shards, batch, n = keys.shape
    buf = torch.empty((shards, shards, batch, cap), dtype=keys.dtype,
                      device=keys.device)
    if buf.numel() == 0:
        return buf
    cuda.launch("dense_send", keys.dtype, keys.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), buf.data_ptr(), shards, batch, n, cap)
    return buf
