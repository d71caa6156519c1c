"""The key distributions the cells draw from (the paper's Section 7.2),
made by torch's generator on the device that sorts them, one call an
array: the same keys for the same seed on the same kind of device.

  UNIF   uniform over [0, 2**30): int32 keys with the two top bits clear,
         as the paper's generator and the port's leave them for tags
  SKEW2  uniform over [0, 100]: massive duplication
"""
from __future__ import annotations

import torch

#: each distribution's exclusive upper end; every one starts at 0
DISTRIBUTIONS = {
    "UNIF": 2 ** 30,
    "SKEW2": 101,
}


def make_keys(name: str, n: int, seed: int, device) -> torch.Tensor:
    """`n` int32 keys of distribution `name` on `device`; `seed` is a
    whole number in [0, 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randint(0, DISTRIBUTIONS[name], (int(n),), generator=g,
                         device=device, dtype=torch.int32)
