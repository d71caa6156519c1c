"""Step functions: prefill_step / serve_step factories.

Counterpart of `repro.models.steps` (`make_train_step` waits for the
training slice). A step is a plain function of (params, batch) or
(params, cache, tokens, pos) that runs without autograd; `serve_step`
updates the cache in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import forward, init_cache


def batch_inputs(batch, cfg: ArchConfig):
    if cfg.family == "encdec":
        return {"enc": batch["enc"], "tokens": batch["tokens"]}
    if cfg.embed_inputs:
        return batch["embeds"]
    return batch["tokens"]


def make_prefill_step(cfg: ArchConfig, ctx, max_seq: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        inputs = batch_inputs(batch, cfg)
        lead = inputs["tokens"] if isinstance(inputs, dict) else inputs
        cache = init_cache(cfg, lead.shape[0], max_seq, ctx,
                           device=lead.device)
        if cfg.family == "encdec":
            cache.pop("enc_out")  # placeholder: prefill computes the encoder
        logits, _, cache = forward(params, inputs, cfg, ctx, cache=cache,
                                   pos=0)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, ctx):
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos: int):
        """tokens: (B, 1) int (or (B,1,d) embeds for vlm); pos: int."""
        logits, _, new_cache = forward(params, tokens, cfg, ctx, cache=cache,
                                       pos=pos)
        return logits[:, -1], new_cache

    return serve_step
