"""torch oracle for the probe-rank kernel (rows)."""
import torch


def probe_ranks_ref(keys, probes):
    """rank[r, m] = #{keys[r] < probes[r, m]} (keys in any order)."""
    return torch.searchsorted(torch.sort(keys, dim=-1).values,
                              probes.contiguous(), side="left"
                              ).to(torch.int32)
