"""Single-source-of-truth parameter layout: shapes + logical axes + init.

Counterpart of `repro.models.params`. `arch_layout(cfg)` returns a flat
{path: ParamSpec} dict; `init_params` and `abstract_params` are views of
the same layout, so the tensors the port serves have the reference's
names, shapes and dtypes. The logical axis names are kept as data (the
port places every parameter on one device). Layer weights carry a leading
L axis, as the reference's scanned layers do.

`params_from_reference(tree)` carries the reference's parameter pytree,
given as NumPy arrays, into the port's tree leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.sort.api import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple            # logical axis name (or None) per dim
    init: str = "normal"      # normal | zeros | ones | ssm_a | ssm_dt


def _attn(prefix, cfg: ArchConfig, L, d=None):
    d = d or cfg.d_model
    qd, kd = cfg.q_dim, cfg.kv_dim
    return {
        f"{prefix}/norm": ParamSpec((L, d), (None, None), "ones"),
        f"{prefix}/wq": ParamSpec((L, d, qd), (None, "fsdp", "tp_heads")),
        f"{prefix}/wk": ParamSpec((L, d, kd), (None, "fsdp", "tp_kv")),
        f"{prefix}/wv": ParamSpec((L, d, kd), (None, "fsdp", "tp_kv")),
        f"{prefix}/wo": ParamSpec((L, qd, d), (None, "tp_heads", "fsdp")),
    }


def _mlp(prefix, cfg: ArchConfig, L, d_ff=None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        f"{prefix}/norm": ParamSpec((L, d), (None, None), "ones"),
        f"{prefix}/w1": ParamSpec((L, d, ff), (None, "fsdp", "tp")),
        f"{prefix}/w3": ParamSpec((L, d, ff), (None, "fsdp", "tp")),
        f"{prefix}/w2": ParamSpec((L, ff, d), (None, "tp", "fsdp")),
    }


def _moe(prefix, cfg: ArchConfig, L):
    d, ffe, E = cfg.d_model, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts
    out = {
        f"{prefix}/norm": ParamSpec((L, d), (None, None), "ones"),
        f"{prefix}/router": ParamSpec((L, d, E), (None, "fsdp", None)),
        # experts shard over their own logical axis (tp_exp); the ffe dim
        # is the FSDP one
        f"{prefix}/w1": ParamSpec((L, E, d, ffe), (None, "tp_exp", None, "fsdp")),
        f"{prefix}/w3": ParamSpec((L, E, d, ffe), (None, "tp_exp", None, "fsdp")),
        f"{prefix}/w2": ParamSpec((L, E, ffe, d), (None, "tp_exp", "fsdp", None)),
    }
    if cfg.n_shared_experts:
        ffs = ffe * cfg.n_shared_experts
        out.update({
            f"{prefix}/shared_w1": ParamSpec((L, d, ffs), (None, "fsdp", "tp")),
            f"{prefix}/shared_w3": ParamSpec((L, d, ffs), (None, "fsdp", "tp")),
            f"{prefix}/shared_w2": ParamSpec((L, ffs, d), (None, "tp", "fsdp")),
        })
    return out


def _mamba(prefix, cfg: ArchConfig, L):
    d, di = cfg.d_model, cfg.d_inner
    g, s, H, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    return {
        f"{prefix}/norm": ParamSpec((L, d), (None, None), "ones"),
        f"{prefix}/wz": ParamSpec((L, d, di), (None, "fsdp", "tp")),
        f"{prefix}/wx": ParamSpec((L, d, di), (None, "fsdp", "tp")),
        f"{prefix}/wB": ParamSpec((L, d, g * s), (None, "fsdp", None)),
        f"{prefix}/wC": ParamSpec((L, d, g * s), (None, "fsdp", None)),
        f"{prefix}/wdt": ParamSpec((L, d, H), (None, "fsdp", "tp")),
        f"{prefix}/conv_x": ParamSpec((L, w, di), (None, None, "tp")),
        f"{prefix}/conv_B": ParamSpec((L, w, g * s), (None, None, None)),
        f"{prefix}/conv_C": ParamSpec((L, w, g * s), (None, None, None)),
        f"{prefix}/A_log": ParamSpec((L, H), (None, "tp"), "ssm_a"),
        f"{prefix}/D": ParamSpec((L, H), (None, "tp"), "ones"),
        f"{prefix}/dt_bias": ParamSpec((L, H), (None, "tp"), "ssm_dt"),
        f"{prefix}/gnorm": ParamSpec((L, di), (None, "tp"), "ones"),
        f"{prefix}/wout": ParamSpec((L, di, d), (None, "tp", "fsdp")),
    }


def arch_layout(cfg: ArchConfig) -> dict:
    V, d, L = cfg.padded_vocab, cfg.d_model, cfg.n_layers
    out = {}
    if not cfg.embed_inputs:
        out["embed/w"] = ParamSpec((V, d), ("tp", "fsdp"))
    if cfg.family in ("dense", "vlm"):
        out.update(_attn("layers/attn", cfg, L))
        out.update(_mlp("layers/mlp", cfg, L))
    elif cfg.family == "moe":
        out.update(_attn("layers/attn", cfg, L))
        out.update(_moe("layers/moe", cfg, L))
    elif cfg.family == "ssm":
        out.update(_mamba("layers/mamba", cfg, L))
    elif cfg.family == "hybrid":
        out.update(_mamba("layers/mamba", cfg, L))
        # single shared transformer block (Zamba2): params reused every
        # shared_attn_period layers; doubled input is projected back to d.
        out["shared/in_proj"] = ParamSpec((2 * d, d), ("fsdp", None))
        out.update({k: ParamSpec(v.shape[1:], v.logical[1:], v.init)
                    for k, v in _attn("shared/attn", cfg, 1).items()})
        out.update({k: ParamSpec(v.shape[1:], v.logical[1:], v.init)
                    for k, v in _mlp("shared/mlp", cfg, 1).items()})
    elif cfg.family == "encdec":
        Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
        out["enc_pos/w"] = ParamSpec((cfg.enc_ctx, d), (None, "fsdp"))
        out.update(_attn("enc_layers/attn", cfg, Le))
        out.update(_mlp("enc_layers/mlp", cfg, Le))
        out.update(_attn("dec_layers/self_attn", cfg, Ld))
        out.update(_attn("dec_layers/cross_attn", cfg, Ld))
        out.update(_mlp("dec_layers/mlp", cfg, Ld))
        out["enc_final_norm"] = ParamSpec((d,), (None,), "ones")
    else:
        raise ValueError(cfg.family)
    out["final_norm"] = ParamSpec((d,), (None,), "ones")
    if not cfg.tie_embeddings:
        out["lm_head/w"] = ParamSpec((d, V), ("fsdp", "tp"))
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def param_dtype(cfg: ArchConfig, spec: ParamSpec) -> torch.dtype:
    """The leaf's dtype: the config's, float32 for the two SSM leaves."""
    if spec.init in ("ssm_a", "ssm_dt"):
        return torch.float32
    return getattr(torch, cfg.dtype)


def _init_one(generator: torch.Generator, spec: ParamSpec, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    gdev = generator.device
    if spec.init in ("ssm_a", "ssm_dt"):
        lo, hi = (1.0, 16.0) if spec.init == "ssm_a" else (1e-3, 1e-1)
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=gdev) * (hi - lo) + lo
        # A in [1, 16): A_log = log(u); dt bias = softplus^-1(u)
        w = torch.log(u) if spec.init == "ssm_a" else torch.log(torch.expm1(u))
        return w.to(device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=gdev)
    w.div_(math.sqrt(fan_in))
    return w.to(device=device, dtype=dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random weights from `generator`, leaf by leaf in sorted path order
    (the reference's order of keys): normal / sqrt(fan_in), zeros, ones,
    and the SSM leaves' A_log and dt bias in float32. The draws run on the
    generator's device and the leaves land on `device`."""
    dev = resolve_device(device)
    flat = {p: _init_one(generator, s, param_dtype(cfg, s), dev)
            for p, s in sorted(arch_layout(cfg).items())}
    return _nest(flat)


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as tensors on the `meta` device: shapes and
    dtypes, no storage."""
    return _nest({p: torch.empty(s.shape, dtype=param_dtype(cfg, s),
                                 device="meta")
                  for p, s in arch_layout(cfg).items()})


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array (NumPy, or anything np.asarray takes) as a tensor on
    `device` with the same dtype and bits. NumPy has no bfloat16: the
    reference's bf16 arrays are ml_dtypes', which torch.from_numpy
    refuses, so they cross as their bits in an int16."""
    dev = resolve_device(device)
    a = np.array(a, copy=True, order="C")     # writable, owned
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def params_from_reference(tree, device="cuda") -> dict:
    """The reference's parameter pytree (nested dicts of arrays) as the
    port's tree on `device`, leaf for leaf."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
