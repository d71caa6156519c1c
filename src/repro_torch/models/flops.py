"""Analytic MODEL_FLOPS (the 'useful work' yardstick for the roofline).

MODEL_FLOPS = 6 * N * D for training (fwd 2ND + bwd 4ND), 2 * N * D for
forward-only (prefill), and 2 * N_active * B per decoded token, where N is
the non-embedding parameter count and N_active replaces expert params by the
top-k routed fraction (+ shared experts). Attention score/value FLOPs
(12 * L * H * hd * S^2-ish) are reported separately since they are not
parameter-proportional.
"""
from __future__ import annotations

import math

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import arch_layout


def _param_counts(cfg: ArchConfig):
    total, expert, embed = 0, 0, 0
    for path, spec in arch_layout(cfg).items():
        n = math.prod(spec.shape)
        if path.startswith("embed/") or path.startswith("lm_head/") or \
                path.startswith("enc_pos/"):
            embed += n
        elif "/moe/w" in path and "shared" not in path:
            expert += n
        else:
            total += n
    return total, expert, embed


def active_params(cfg: ArchConfig) -> int:
    dense, expert, _ = _param_counts(cfg)
    if cfg.n_experts:
        return dense + expert * cfg.top_k // cfg.n_experts
    return dense + expert


def total_params(cfg: ArchConfig) -> int:
    dense, expert, embed = _param_counts(cfg)
    return dense + expert + embed


def attention_flops(cfg: ArchConfig, seq: int, causal: bool = True) -> int:
    """Per-sequence QK^T + PV FLOPs (excluded from 6ND)."""
    if not cfg.n_heads:
        return 0
    L = cfg.n_dec_layers + cfg.n_enc_layers if cfg.family == "encdec" \
        else cfg.n_layers
    if cfg.family == "hybrid":
        L = len([s for s in range(0, cfg.n_layers, cfg.shared_attn_period or
                                  cfg.n_layers)])
    per = 4 * cfg.n_heads * cfg.head_dim * seq * seq
    if causal:
        per //= 2
    return L * per


def model_flops(cfg: ArchConfig, kind: str, seq: int, batch: int) -> int:
    """Whole-step analytic FLOPs across all chips."""
    n = active_params(cfg)
    # embedding output projection is a real matmul: count lm_head
    _, _, embed = _param_counts(cfg)
    n_mm = n + embed // 2   # lm_head half of embed+head (tied counts once)
    tokens = batch * seq
    if kind == "train":
        return 6 * n_mm * tokens + 3 * attention_flops(cfg, seq) * batch
    if kind == "prefill":
        return 2 * n_mm * tokens + attention_flops(cfg, seq) * batch
    if kind == "decode":
        # one token per sequence against a seq-length cache
        attn = 0
        if cfg.n_heads:
            L = cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers
            if cfg.family == "hybrid":
                L = len(range(0, cfg.n_layers,
                              cfg.shared_attn_period or cfg.n_layers))
            window = cfg.attn_window or seq
            attn = 4 * L * cfg.n_heads * cfg.head_dim * min(seq, window)
        return (2 * n_mm + attn) * batch
    raise ValueError(kind)
