"""Probe ranks over rows (counterpart of repro.kernels.histogram.ops).

`probe_ranks` flattens any leading axes to the kernels' rows, with
per-row probes (the reference's batched form, ops.py:32) or one probe
vector shared by every row (its unbatched form, ops.py:17), through the
kernel it is given: K4 counts keys in any order (the default); K4s
searches rows sorted ascending. Neither kernel needs the reference's tile
padding (ops.py:38-41): K4s searches the row as it is and K4 masks the
ragged tile edge itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.histogram.kernel import probe_rank_count


def probe_ranks(keys: torch.Tensor, probes: torch.Tensor,
                kernel=probe_rank_count) -> torch.Tensor:
    """rank[..., m] = #{keys[...] < probes[..., m]} by `kernel`
    (`probe_rank_count`, or `probe_rank_search` over rows sorted
    ascending): keys (..., n); probes (..., M) with the same leading axes,
    or (M,) shared by every row -> (..., M)."""
    lead = keys.shape[:-1]
    if probes.dim() == 1:
        probes = probes.expand(lead + probes.shape)
    if probes.shape[:-1] != lead:
        raise ValueError(f"probe_ranks: probes {tuple(probes.shape)} do not "
                         f"match keys {tuple(keys.shape)}")
    m = probes.shape[-1]
    ranks = kernel(keys.reshape(-1, keys.shape[-1]),
                   probes.reshape(-1, m).contiguous())
    return ranks.reshape(lead + (m,))


def probe_counts(keys: torch.Tensor, probes: torch.Tensor, *,
                 policy: str = "auto") -> torch.Tensor:
    """Histogram of keys in ANY order against sorted probes (counterpart of
    histogram/ops.py:48): count[..., m] = #{probes[m-1] <= key <
    probes[m]}, the first bucket below probes[0] and the last at or above
    probes[-1]; keys (..., n), probes (M,) or (..., M) -> (..., M+1)
    int32, from `dispatch.probe_ranks(..., assume_sorted=False)`."""
    from repro_torch.kernels import dispatch

    r = dispatch.probe_ranks(keys, probes, policy=policy,
                             assume_sorted=False)
    lead = r.shape[:-1]
    zero = torch.zeros(lead + (1,), dtype=torch.int32, device=r.device)
    n = torch.full(lead + (1,), keys.shape[-1], dtype=torch.int32,
                   device=r.device)
    return torch.diff(torch.cat([zero, r, n], dim=-1), dim=-1)


#: The reference's batched name; `probe_ranks` already takes probe rows.
probe_ranks_batched = probe_ranks
