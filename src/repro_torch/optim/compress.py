"""Error-feedback gradient compression (counterpart of
repro.optim.compress).

int8 per-tensor-scaled quantization with an error-feedback accumulator:
the quantization residual is carried into the next step, so the
compression bias vanishes over steps (Karimireddy et al., "Error Feedback
Fixes SignSGD"). top-k sparsification keeps the largest entries, with the
same feedback. Both are functions of (grads, state) that return new trees.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.lm import tree_leaves, tree_map, tree_unflatten


class CompressorState(NamedTuple):
    error: dict   # same tree as grads, float32 residuals


def init_compressor(params) -> CompressorState:
    return CompressorState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _quant_dequant_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _with_feedback(one, grads, state: CompressorState):
    pairs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                       tree_leaves(state.error))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            CompressorState(error=tree_unflatten(grads,
                                                 [p[1] for p in pairs])))


def error_feedback_int8(grads, state: CompressorState):
    """Returns (compressed grads, new state); the residual is carried to
    the next step."""
    def one(g, e):
        gf = g.float() + e
        gq = _quant_dequant_int8(gf)
        return gq.to(g.dtype), gf - gq
    return _with_feedback(one, grads, state)


def topk_sparsify(grads, state: CompressorState, frac: float = 0.01):
    """Keep the largest `frac` entries (by magnitude) + error feedback; the
    threshold is the k-th largest magnitude."""
    def one(g, e):
        gf = g.float() + e
        flat = gf.reshape(-1)
        k = max(1, int(flat.shape[0] * frac))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        kept = torch.where(torch.abs(gf) >= thresh, gf, 0.0)
        return kept.to(g.dtype), gf - kept
    return _with_feedback(one, grads, state)
