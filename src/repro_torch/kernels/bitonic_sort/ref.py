"""torch.sort oracles for the bitonic kernels (rows)."""
import torch


def block_sort_ref(x, block):
    rows, n = x.shape
    return torch.sort(x.reshape(rows, n // block, block), dim=-1
                      ).values.reshape(rows, n)


def merge_pass_ref(x, run):
    rows, n = x.shape
    return torch.sort(x.reshape(rows, n // (2 * run), 2 * run), dim=-1
                      ).values.reshape(rows, n)


def local_sort_ref(x):
    return torch.sort(x, dim=-1).values
