"""Global-norm gradient clipping (counterpart of repro.optim.clip)."""
from __future__ import annotations

import torch

from repro_torch.models.lm import tree_leaves, tree_map


def global_norm(tree):
    """sqrt of the float32 sum of squares over the leaves, leaf by leaf in
    tree order (a 0-d tensor on the leaves' device)."""
    sq = sum(torch.sum(torch.square(t.float())) for t in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm); each leaf scaled in
    float32 and cast back to its dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
