"""Model assembly: forward, prefill and single-token decode for all assigned
families (dense / moe / ssm / hybrid / encdec / vlm).

Counterpart of `repro.models.lm`, forward only. Layer params carry a
leading L axis; the reference's `lax.scan` over them is a Python loop here
(remat has no meaning for serving), and a decode cache is a tree of
stacked (L, ...) tensors that each step updates in place, layer by layer
(the serving loop owns it, as the reference's donated cache). The hybrid
(Zamba2) family interleaves loop segments with its single shared
attention block.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import attn_block, mlp_block, rmsnorm
from repro_torch.models.moe import moe_block
from repro_torch.models.ssm import init_ssm_cache, mamba_block
from repro_torch.sort.api import resolve_device


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts and tuples (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def _store(full: torch.Tensor, new: torch.Tensor):
    """full[...] = new unless `new` already is that memory (a cache slice
    the layer wrote in place)."""
    if new.data_ptr() != full.data_ptr() or new.stride() != full.stride():
        full.copy_(new)


# --------------------------------------------------------------- embedding
def embed(params, tokens, cfg: ArchConfig, ctx):
    w = params["embed"]["w"]
    return w[tokens.long()].to(getattr(torch, cfg.dtype))


def unembed(params, h, cfg: ArchConfig, ctx):
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["w"].T
    else:
        logits = h @ params["lm_head"]["w"]
    # mask vocab padding
    valid = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab
    return torch.where(valid, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=h.device))


# ------------------------------------------------------------ layer bodies
def _dense_body(cfg, ctx, causal=True):
    def body(h, lp, positions, cache=None, pos=None):
        h, kv = attn_block(h, lp["attn"], positions=positions, cfg=cfg,
                           ctx=ctx, cache=cache and cache.get("kv"), pos=pos,
                           causal=causal)
        h = mlp_block(h, lp["mlp"], cfg, ctx)
        new_cache = {"kv": kv} if cache is not None else None
        return h, new_cache, {}
    return body


def _moe_body(cfg, ctx):
    def body(h, lp, positions, cache=None, pos=None):
        h, kv = attn_block(h, lp["attn"], positions=positions, cfg=cfg,
                           ctx=ctx, cache=cache and cache.get("kv"), pos=pos)
        h, aux = moe_block(h, lp["moe"], cfg, ctx)
        new_cache = {"kv": kv} if cache is not None else None
        return h, new_cache, aux
    return body


def _ssm_body(cfg, ctx):
    def body(h, lp, positions, cache=None, pos=None):
        h, nc = mamba_block(h, lp["mamba"], cfg, ctx, cache=cache)
        return h, nc, {}
    return body


def _n_layers(layer_params) -> int:
    leaves = []
    tree_map(leaves.append, layer_params)
    return leaves[0].shape[0]


def _scan_layers(body, h, layer_params, positions, cfg, *, ctx=None,
                 cache=None, pos=None):
    """Run `body` over the stacked layer params (and per-layer cache,
    written back in place). Returns (h, cache, aux stacked over layers)."""
    auxes = []
    for i in range(_n_layers(layer_params)):
        lp = tree_map(lambda t: t[i], layer_params)
        lc = tree_map(lambda t: t[i], cache)
        h, nc, aux = body(h, lp, positions, cache=lc, pos=pos)
        if cache is not None:
            tree_map(_store, lc, nc)
        auxes.append(aux)
    aux = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
    return h, cache, aux


# ------------------------------------------------------- forward (by family)
def _hybrid_segments(cfg: ArchConfig):
    """Layer-count segments between shared-attention applications."""
    per = cfg.shared_attn_period or cfg.n_layers
    segs, left = [], cfg.n_layers
    while left > 0:
        segs.append(min(per, left))
        left -= per
    return segs


def _shared_attn(h, h0, params, cfg, ctx, positions, cache=None, pos=None,
                 idx=0):
    """Zamba2 shared block: concat(current, embedding output) -> proj -> attn
    -> mlp with one shared parameter set; per-application KV cache slot."""
    sp = params["shared"]
    x = torch.cat([h, h0], dim=-1) @ sp["in_proj"]
    kv = None
    if cache is not None:
        kv = tuple(c[idx] for c in cache["shared_kv"])
    x, new_kv = attn_block(x, sp["attn"], positions=positions, cfg=cfg,
                           ctx=ctx, cache=kv, pos=pos)
    if cache is not None:
        tree_map(_store, kv, new_kv)
    x = mlp_block(x, sp["mlp"], cfg, ctx)
    return h + x, new_kv


def _positions(s: int, pos, device):
    base = torch.arange(s, device=device)
    return base if pos is None else base + int(pos)


def forward(params, inputs, cfg: ArchConfig, ctx, *, cache=None, pos=None):
    """inputs: tokens (B,S) int, or embeddings (B,S,d) for vlm; for encdec a
    dict {enc: (B,enc_ctx,d), tokens: (B,S)}. Returns (logits, aux, cache);
    a given cache is updated in place and returned."""
    if cfg.family == "encdec":
        return _forward_encdec(params, inputs, cfg, ctx, cache=cache, pos=pos)

    if cfg.embed_inputs:
        h = inputs.to(getattr(torch, cfg.dtype))
    else:
        h = embed(params, inputs, cfg, ctx)
    s = h.shape[1]
    positions = _positions(s, pos, h.device)

    aux = {}
    if cfg.family in ("dense", "vlm", "moe", "ssm"):
        body = {"dense": _dense_body, "vlm": _dense_body, "moe": _moe_body,
                "ssm": _ssm_body}[cfg.family](cfg, ctx)
        h, new_cache, aux = _scan_layers(body, h, params["layers"], positions,
                                         cfg, ctx=ctx, cache=cache, pos=pos)
    elif cfg.family == "hybrid":
        h0 = h
        body = _ssm_body(cfg, ctx)
        off = 0
        for i, seg in enumerate(_hybrid_segments(cfg)):
            h, _ = _shared_attn(h, h0, params, cfg, ctx, positions,
                                cache=cache, pos=pos, idx=i)
            lp = tree_map(lambda t: t[off:off + seg], params["layers"])
            lc = None
            if cache is not None:
                lc = tree_map(lambda t: t[off:off + seg], cache["mamba"])
            h, _, _ = _scan_layers(body, h, lp, positions, cfg, ctx=ctx,
                                   cache=lc, pos=pos)
            off += seg
        new_cache = cache
    else:
        raise ValueError(cfg.family)

    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, h, cfg, ctx)
    return logits, aux, new_cache


def _forward_encdec(params, inputs, cfg: ArchConfig, ctx, *, cache=None,
                    pos=None):
    dt = getattr(torch, cfg.dtype)
    if cache is None or "enc_out" not in cache:
        enc = inputs["enc"].to(dt) + params["enc_pos"]["w"][None].to(dt)
        epos = torch.arange(cfg.enc_ctx, device=enc.device)
        ebody = _dense_body(cfg, ctx, causal=False)
        enc, _, _ = _scan_layers(ebody, enc, params["enc_layers"], epos, cfg,
                                 ctx=ctx)
        enc = rmsnorm(enc, params["enc_final_norm"], cfg.norm_eps)
    else:
        enc = cache["enc_out"]

    tokens = inputs["tokens"] if isinstance(inputs, dict) else inputs
    h = embed(params, tokens, cfg, ctx)
    positions = _positions(h.shape[1], pos, h.device)

    def body(hh, lp, positions, cache=None, pos=None):
        hh, kv = attn_block(hh, lp["self_attn"], positions=positions, cfg=cfg,
                            ctx=ctx, cache=cache and cache.get("kv"), pos=pos)
        hh, _ = attn_block(hh, lp["cross_attn"], positions=positions,
                           cfg=cfg, ctx=ctx, kv_override=enc)
        hh = mlp_block(hh, lp["mlp"], cfg, ctx)
        nc = {"kv": kv} if cache is not None else None
        return hh, nc, {}

    lc = cache["dec"] if cache is not None else None
    h, new_dec_cache, _ = _scan_layers(body, h, params["dec_layers"],
                                       positions, cfg, ctx=ctx, cache=lc,
                                       pos=pos)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, h, cfg, ctx)
    new_cache = None
    if cache is not None:
        new_cache = {"dec": new_dec_cache, "enc_out": enc}
    return logits, {}, new_cache


# ------------------------------------------------------------------- cache
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, ctx,
               device="cuda") -> dict:
    """Zeroed cache tree for decode, on `device`.

    Sliding-window archs get a *ring buffer* of window size: a long
    decode then holds O(window) KV instead of O(context) (Mistral-style
    rolling cache; slot = position mod window)."""
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    L = cfg.n_layers

    def kv(n_layers, seq):
        if cfg.attn_window:
            seq = min(seq, cfg.attn_window)
        shape = (n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return {"kv": (torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(shape, dtype=dt, device=device))}

    if cfg.family in ("dense", "vlm", "moe"):
        return kv(L, max_seq)
    if cfg.family == "ssm":
        return init_ssm_cache(cfg, batch, dt, device, layers=L)
    if cfg.family == "hybrid":
        return {"mamba": init_ssm_cache(cfg, batch, dt, device, layers=L),
                "shared_kv": kv(len(_hybrid_segments(cfg)), max_seq)["kv"]}
    if cfg.family == "encdec":
        return {"dec": kv(cfg.n_dec_layers, max_seq),
                "enc_out": torch.zeros((batch, cfg.enc_ctx, cfg.d_model),
                                       dtype=dt, device=device)}
    raise ValueError(cfg.family)
