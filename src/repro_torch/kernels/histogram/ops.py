"""Probe ranks over rows (counterpart of repro.kernels.histogram.ops).

`probe_ranks` flattens any leading axes to K4's rows, with per-row probes
(the reference's batched form, ops.py:32) or one probe vector shared by
every row (its unbatched form, ops.py:17). K4 masks the ragged tile edge
itself; its plain version pads each row to the tile with the hi sentinel,
as the reference does at ops.py:38-41.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.histogram.kernel import probe_rank_count


def probe_ranks(keys: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """rank[..., m] = #{keys[...] < probes[..., m]}; keys need not be
    sorted. keys (..., n); probes (..., M) with the same leading axes, or
    (M,) shared by every row -> (..., M)."""
    lead = keys.shape[:-1]
    if probes.dim() == 1:
        probes = probes.expand(lead + probes.shape)
    if probes.shape[:-1] != lead:
        raise ValueError(f"probe_ranks: probes {tuple(probes.shape)} do not "
                         f"match keys {tuple(keys.shape)}")
    m = probes.shape[-1]
    ranks = probe_rank_count(keys.reshape(-1, keys.shape[-1]),
                             probes.reshape(-1, m).contiguous())
    return ranks.reshape(lead + (m,))


#: The reference's batched name; `probe_ranks` already takes probe rows.
probe_ranks_batched = probe_ranks
