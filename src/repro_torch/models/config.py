"""Architecture configuration for the assigned model families.

Counterpart of `repro.models.config`, field for field: a config is shapes
and options only, with no weights.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.common import round_up


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    # cast expert weights to this dtype before the expert FFN (the
    # reference's FSDP all-gather dtype); "" = the param dtype
    moe_gather_dtype: str = ""
    # cast dispatch/return all_to_all payloads to this dtype
    moe_a2a_dtype: str = ""
    # --- SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # --- hybrid (zamba2): shared attention block applied every k ssm layers
    shared_attn_period: int = 0
    # --- enc-dec (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_ctx: int = 0               # precomputed frame embeddings (stub frontend)
    # --- vlm (pixtral): inputs are precomputed patch/token embeddings (stub)
    embed_inputs: bool = False
    # --- common
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    vocab_pad_multiple: int = 512
    tie_embeddings: bool = False
    remat: str = "block"           # none | block (training only)
    optimizer: str = "adamw"       # adamw | adafactor (training only)
    attn_chunk: int = 1024         # flash-style chunking threshold/size
    attn_window: int = 0           # sliding window for hybrid long-context
    subquadratic: bool = False     # eligible for long_500k decode
    scan_unroll: bool = False      # the reference's scan unrolling (no-op here)
    dtype: str = "bfloat16"

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab, self.vocab_pad_multiple)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def heads_shardable(self, tp: int) -> bool:
        """Q heads must divide the TP axis to head-shard; small KV-head counts
        are repeated to Hq under TP (Megatron-style GQA expansion)."""
        if self.n_heads == 0:
            return True
        return self.n_heads % tp == 0

    def param_count(self) -> int:
        """Total (not active) parameter count, padding excluded."""
        from repro_torch.models.params import arch_layout
        return sum(math.prod(spec.shape)
                   for spec in arch_layout(self).values())
