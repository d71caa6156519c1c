"""Step functions: train_step / prefill_step / serve_step factories.

Counterpart of `repro.models.steps`. A step is a plain function of
(params, opt_state, batch), (params, batch) or (params, cache, tokens,
pos). `train_step` differentiates the forward and its loss with autograd
and updates the parameters and the optimizer state in place (the
reference donates them); it reads nothing on the host, so its metrics are
device tensors. `prefill_step` and `serve_step` run without autograd;
`serve_step` updates the cache in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import (forward, init_cache, lm_loss, tree_leaves,
                                   tree_unflatten)
from repro_torch.optim.clip import clip_by_global_norm

MOE_AUX_WEIGHT = 0.01


def batch_inputs(batch, cfg: ArchConfig):
    if cfg.family == "encdec":
        return {"enc": batch["enc"], "tokens": batch["tokens"]}
    if cfg.embed_inputs:
        return batch["embeds"]
    return batch["tokens"]


def make_train_step(cfg: ArchConfig, ctx, optimizer, lr_schedule,
                    max_grad_norm: float = 1.0):
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                logits, aux, _ = forward(params, batch_inputs(batch, cfg),
                                         cfg, ctx)
                loss = lm_loss(logits, batch["labels"], cfg)
                if cfg.family == "moe" and "router_mean_prob" in aux:
                    # load-balance proxy: E * sum(mean_prob^2) per layer
                    mp = aux["router_mean_prob"]
                    aux_loss = cfg.n_experts * torch.sum(mp * mp,
                                                         dim=-1).mean()
                    loss = loss + MOE_AUX_WEIGHT * aux_loss
                del logits      # freed once the backward has used it
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads),
                                           max_grad_norm)
        lr = lr_schedule(opt_state["count"])
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}
        if cfg.family == "moe" and "dropped" in aux:
            metrics["moe_dropped"] = torch.sum(aux["dropped"],
                                               dtype=torch.int32)
        return params, opt_state, metrics

    return train_step


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
