"""Order-preserving key encodings onto int32 (paper Section 6.3 support).

Counterpart of `repro.core.tagging` for 32-bit keys. The core sorts int32
only, so the front door maps every key type onto it first:

  float32 -> int32  the IEEE-754 bijection (negative floats bitwise NOT,
                    nonnegative floats get the sign bit, then recentre);
  uint32  -> int32  a flip of the top bit, which maps unsigned order onto
                    signed order (torch has no uint32 `lt` or
                    `searchsorted`, so the flip happens before the core).

`tag_bits` is the packing budget of implicit duplicate tagging. The
float64/int64 bijection and int64 packing come with the next slice.
"""
from __future__ import annotations

import math

import torch

_SIGN = -2147483648          # 0x80000000 as an int32 bit pattern
_LOW31 = 0x7FFFFFFF


def float32_to_sortable_int32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection float32 -> int32 (IEEE-754 trick)."""
    i = x.view(torch.int32)
    u = torch.where(i < 0, torch.bitwise_not(i), i | _SIGN)
    return u ^ _SIGN


def sortable_int32_to_float32(s: torch.Tensor) -> torch.Tensor:
    u = s ^ _SIGN
    i = torch.where(u >= 0, torch.bitwise_not(u), u & _LOW31)
    return i.view(torch.float32)


def uint32_to_sortable_int32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection uint32 -> int32: flip the top bit."""
    return x.view(torch.int32) ^ _SIGN


def sortable_int32_to_uint32(s: torch.Tensor) -> torch.Tensor:
    return (s ^ _SIGN).view(torch.uint32)


def tag_bits(p: int, n_local: int) -> int:
    return max(1, math.ceil(math.log2(p * n_local)))
