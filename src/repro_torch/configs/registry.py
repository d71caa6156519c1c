"""Arch registry + reduced smoke variants."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ArchConfig

_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "granite-34b": "granite_34b",
    "starcoder2-3b": "starcoder2_3b",
    "stablelm-12b": "stablelm_12b",
    "granite-20b": "granite_20b",
    "mamba2-370m": "mamba2_370m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "kimi-k2-1t-a32b": "kimi_k2",
    "whisper-large-v3": "whisper_large_v3",
    "pixtral-12b": "pixtral_12b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    """Reduced same-family config: tiny widths/layers, tiny vocab — one CPU
    forward/train step must run in seconds while exercising every code path
    (GQA ratios, MoE routing, SSD chunking, shared blocks, enc-dec)."""
    cfg = get_config(arch_id)
    kv = 1 if cfg.n_kv_heads == 1 else (2 if cfg.n_heads else 0)
    heads = 4 if cfg.n_heads else 0
    changes = dict(
        n_layers=2,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        vocab_pad_multiple=8,
        attn_chunk=16,
        attn_window=min(cfg.attn_window, 16) if cfg.attn_window else 0,
    )
    if cfg.family == "moe":
        # high capacity factor: decode/prefill/train must agree in smoke tests.
        # fp32 compute: the decode-vs-forward smoke comparison runs the same
        # math through differently shaped programs (full-sequence forward vs
        # prefill + cached decode); in bf16 the reassociated reductions drift
        # past any honest tolerance on a routed (MoE) model, while fp32 agrees
        # to ~1e-6. Production configs keep bf16 — this is smoke-only.
        changes.update(n_experts=4, top_k=2, d_ff_expert=64,
                       moe_capacity_factor=4.0, moe_gather_dtype="",
                       dtype="float32")
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                       n_layers=3 if cfg.family == "hybrid" else 2)
        if cfg.family == "hybrid":
            changes.update(shared_attn_period=2)
    if cfg.family == "encdec":
        changes.update(n_layers=4, n_enc_layers=2, n_dec_layers=2, enc_ctx=16)
    return dataclasses.replace(cfg, **changes)
