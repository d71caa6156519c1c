"""Optimizers: AdamW and Adafactor as (init, update) pairs (counterpart of
repro.optim.optimizers).

The arithmetic is the reference's step for step. AdamW keeps its moments
in `moment_dtype` (float32 by default); Adafactor keeps a factored second
moment (row and column vectors) for leaves of two or more dimensions and
a bf16 first moment. The bias corrections and the learning rate stay
device tensors: an update reads nothing on the host.

`update(grads, state, params, lr)` writes the new parameters and state
into the given tensors under `torch.no_grad()` and returns the same two
trees, as the reference's train step donates its parameters and state
(`donate_argnums=(0, 1)`): the card holds one copy of each. The third
member, `state_pspecs`, maps the parameter specs
(`models.params.param_pspecs`) to the state's: the state inherits each
parameter's sharding, so ZeRO follows from the parameter layout.

`state_from_reference(tree)` carries the reference's optimizer state (its
NumPy leaves; bf16 bit for bit) into the port's tree, as
`models.params.params_from_reference` carries the parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.models.params import params_from_reference
from repro_torch.parallel.ctx import PSpec, map_specs


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable                 # params -> state
    update: Callable               # (grads, state, params, lr) -> (params, state)
    state_pspecs: Callable         # param_pspecs -> state pspecs


def _zeros(p, dtype):
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _count(params):
    """The step counter: a 0-d int32 on the parameters' device."""
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          moment_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: _zeros(p, moment_dtype), params),
                "v": tree_map(lambda p: _zeros(p, moment_dtype), params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state["count"] + 1
        bc1 = 1 - b1 ** c.float()
        bc2 = 1 - b2 ** c.float()

        def upd(g, m, v, p):
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            step = step + weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            m.copy_(m_new)
            v.copy_(v_new)

        tree_map(upd, grads, state["m"], state["v"], params)
        state["count"].copy_(c)
        return params, state

    def state_pspecs(pspecs):
        return {"m": pspecs, "v": pspecs, "count": PSpec()}

    return Optimizer(init, update, state_pspecs)


def adafactor(decay=0.99, eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
              momentum_dtype=torch.bfloat16) -> Optimizer:
    """Factored second moment for >= 2-D leaves; a full vector for 1-D."""
    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def v_init(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"m": tree_map(lambda p: _zeros(p, momentum_dtype), params),
                "v": tree_map(v_init, params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state["count"] + 1

        def upd(g, m, vf, p):
            gf = g.float()
            g2 = gf * gf + eps
            if _factored(p.shape):
                r = decay * vf["r"] + (1 - decay) * g2.mean(dim=-1)
                col = decay * vf["c"] + (1 - decay) * g2.mean(dim=-2)
                rc = r / torch.clamp(r.mean(dim=-1, keepdim=True), min=eps)
                vhat = rc[..., None] * col[..., None, :]
                vf["r"].copy_(r)
                vf["c"].copy_(col)
            else:
                vhat = decay * vf["v"] + (1 - decay) * g2
                vf["v"].copy_(vhat)
            u = gf * torch.rsqrt(vhat + eps)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            m_new = 0.9 * m.float() + 0.1 * u
            p.copy_(p.float() - lr * (m_new + weight_decay * p.float()))
            m.copy_(m_new)

        tree_map(upd, grads, state["m"], state["v"], params)
        state["count"].copy_(c)
        return params, state

    def state_pspecs(pspecs):
        def v_spec(ps):
            parts = tuple(ps) if ps is not None else ()
            if len(parts) >= 2:
                # r drops the last dimension, c the one before it
                return {"r": PSpec(*parts[:-1]),
                        "c": PSpec(*(parts[:-2] + parts[-1:]))}
            return {"v": PSpec(*parts)}

        return {"m": pspecs, "v": map_specs(v_spec, pspecs),
                "count": PSpec()}

    return Optimizer(init, update, state_pspecs)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)


def state_from_reference(tree, device="cuda"):
    """The reference's optimizer state (nested dicts of NumPy arrays: m, v,
    count) as the port's tree on `device`, leaf for leaf and bit for bit."""
    return params_from_reference(tree, device)
