"""torch.sort oracles for the k-way merge kernels (rows).

The merge kernels are exact: their output is bit-identical to a full sort
over the same entries (sentinel padding included)."""
import torch


def merge_sorted_runs_ref(runs):
    """(rows, k, r) -> (rows, k*r) ascending; ignores the run structure."""
    return torch.sort(runs.reshape(runs.shape[0], -1), dim=-1).values
