"""Assigned input shapes — every arch is paired with all four (40 cells).

train_*   lower train_step (forward+backward+optimizer)
prefill_* lower prefill_step (forward building a KV cache)
decode_* / long_* lower serve_step (one token against a seq_len cache)

long_500k requires sub-quadratic context handling: only SSM/hybrid archs run
it; pure full-attention archs are recorded as SKIP in the dry-run matrix
(DESIGN.md Section 5).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def long_ctx_eligible(cfg: ArchConfig) -> bool:
    return cfg.subquadratic


def cells(arch_ids, configs=None):
    """All (arch, shape) cells with skip annotations."""
    from repro_torch.configs.registry import get_config
    out = []
    for a in arch_ids:
        cfg = configs[a] if configs else get_config(a)
        for s in SHAPES.values():
            skip = (s.name == "long_500k" and not long_ctx_eligible(cfg))
            out.append((a, s.name, "SKIP(full-attention)" if skip else "RUN"))
    return out
