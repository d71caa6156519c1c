"""Order-preserving key encodings onto signed ints (paper Section 6.3
support).

Counterpart of `repro.core.tagging`. The core sorts int32 or int64, so the
front door maps every key type onto one of them first:

  float32 -> int32  the IEEE-754 bijection (negative floats bitwise NOT,
                    nonnegative floats get the sign bit, then recentre);
  float64 -> int64  the same bijection on 64 bits; exact for every bit
                    pattern, NaN payloads, +-0 and +-inf included;
  uint32  -> int32  a flip of the top bit, which maps unsigned order onto
                    signed order (torch has no uint32 `lt` or
                    `searchsorted`, so the flip happens before the core).

`tag_bits` is the packing budget of implicit duplicate tagging.
"""
from __future__ import annotations

import math

import torch

from repro_torch.runtime.syncs import to_device

_SIGN = -2147483648          # 0x80000000 as an int32 bit pattern
_LOW31 = 0x7FFFFFFF
_SIGN64 = -2 ** 63           # 0x8000000000000000 as an int64 bit pattern
_LOW63 = 2 ** 63 - 1


def float32_to_sortable_int32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection float32 -> int32 (IEEE-754 trick)."""
    i = x.view(torch.int32)
    u = torch.where(i < 0, torch.bitwise_not(i), i | _SIGN)
    return u ^ _SIGN


def sortable_int32_to_float32(s: torch.Tensor) -> torch.Tensor:
    u = s ^ _SIGN
    i = torch.where(u >= 0, torch.bitwise_not(u), u & _LOW31)
    return i.view(torch.float32)


def float64_to_sortable_int64(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection float64 -> int64 (IEEE-754 trick)."""
    i = x.view(torch.int64)
    u = torch.where(i < 0, torch.bitwise_not(i), i | _SIGN64)
    return u ^ _SIGN64


def sortable_int64_to_float64(s: torch.Tensor) -> torch.Tensor:
    u = s ^ _SIGN64
    i = torch.where(u >= 0, torch.bitwise_not(u), u & _LOW63)
    return i.view(torch.float64)


def uint32_to_sortable_int32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection uint32 -> int32: flip the top bit."""
    return x.view(torch.int32) ^ _SIGN


def sortable_int32_to_uint32(s: torch.Tensor) -> torch.Tensor:
    return (s ^ _SIGN).view(torch.uint32)


def tag_bits(p: int, n_local: int) -> int:
    return max(1, math.ceil(math.log2(p * n_local)))


def pack_tagged(keys: torch.Tensor, shard_id, *, p: int, n_local: int,
                key_bits: int) -> torch.Tensor:
    """Pack integer keys in [0, 2^key_bits) with a unique tag a key
    (counterpart of core/tagging.py:72): (key << b) | (shard_id * n_local
    + index), b = tag_bits(p, n_local), so keys order as the paper's
    (key, shard, index) triplets. int32 when key_bits + b <= 31, int64
    when <= 63 (the port needs no x64 switch), else ValueError."""
    b = tag_bits(p, n_local)
    total = key_bits + b
    if total <= 31:
        dt = torch.int32
    elif total <= 63:
        dt = torch.int64
    else:
        raise ValueError(f"key_bits={key_bits} + tag_bits={b} > 63")
    keys = torch.as_tensor(keys).to(dt)
    tag = (to_device(shard_id, dt, keys.device) * n_local
           + torch.arange(n_local, dtype=dt, device=keys.device))
    return (keys << b) | tag


def unpack_tagged(tagged: torch.Tensor, *, p: int, n_local: int
                  ) -> torch.Tensor:
    """The keys of `pack_tagged` (core/tagging.py:97)."""
    return tagged >> tag_bits(p, n_local)
