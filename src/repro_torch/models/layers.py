"""Core layers: RMSNorm, RoPE, GQA attention (full / chunked-causal flash /
context-parallel / decode-with-cache), SwiGLU MLP. Forward only.

Counterpart of `repro.models.layers`: plain functions over param dicts of
tensors, written as explicit torch ops that follow the reference's
algorithm (its chunked online softmax pair by pair, its masks), so the
same inputs give the same numbers. A score product runs in float32, as the
reference asks with `preferred_element_type`. The reference's sharding
constraints only pin layouts and are left out; what tensor parallelism
changes in the arithmetic runs over the ctx's emulated tp shards
(`attention_seqpar`, `expand_kv`).

The reference's `jax.lax.dynamic_update_slice_in_dim` clamps its start so
that the update fits; `update_slice` does the same, writing in place (the
serving loop owns its cache, as the reference's donated one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rmsnorm(x, w, eps: float):
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * w.to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (S,) or (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq       # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def update_slice(full, update, start: int, dim: int):
    """full[start : start + n] along `dim` = update, in place; the start
    clamps to [0, size - n] as jax.lax.dynamic_update_slice_in_dim's
    does. Returns `full`."""
    n = update.shape[dim]
    start = min(max(int(start), 0), full.shape[dim] - n)
    full.narrow(dim, start, n).copy_(update)
    return full


def _scores(q, k, scale):
    """einsum bqhgd,bkhd->bhgqk in float32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale


def _sdpa(q, k, v, mask, scale):
    """q: (B,Sq,Hkv,G,D), k/v: (B,Skv,Hkv,D); mask broadcastable (B,1,1,Sq,Skv)."""
    s = _scores(q, k, scale)
    s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def attention_full(q, k, v, *, causal: bool, ctx=None, window: int = 0):
    """q: (B,S,Hq,D); k/v: (B,Skv,Hkv,D). Materializes (S,Skv) scores."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = (torch.ones((sq, skv), dtype=torch.bool, device=q.device)
            if not causal else qi >= ki)
    if window:
        mask = mask & (qi - ki < window)
    o = _sdpa(qg, k, v, mask[None, None, None], 1.0 / math.sqrt(d))
    return o.reshape(b, sq, hq, d)


def _pair_lists(t: int, chunk: int, causal: bool, window: int):
    """The (q chunk, kv chunk) pairs the flash scan visits, in order."""
    return [(i, j) for i in range(t) for j in range(i + 1 if causal else t)
            if not window or (i - j) * chunk < window + chunk]


def _pair_mask(i, j, chunk: int, causal: bool, window: int, device, off=0):
    qi_ = off + i * chunk + torch.arange(chunk, device=device)[:, None]
    ki_ = j * chunk + torch.arange(chunk, device=device)[None, :]
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qi_ >= ki_)
    if window:
        mask = mask & (qi_ - ki_ < window)
    return mask


def _online_softmax(qg, k, v, pairs, chunk, mask_fn):
    """The flash scan's carry over `pairs`: acc (b,s,hkv,g,d), m and l
    (b,hkv,g,s), all float32; one online-softmax step a pair."""
    b, s, hkv, g, d = qg.shape
    scale = 1.0 / math.sqrt(d)
    dev = qg.device
    acc = torch.zeros((b, s, hkv, g, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, g, s), -math.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=dev)
    for i, j in pairs:
        qs, ks = slice(i * chunk, (i + 1) * chunk), slice(j * chunk,
                                                          (j + 1) * chunk)
        sco = _scores(qg[:, qs], k[:, ks], scale)
        mask = mask_fn(i, j)[None, None, None]
        sco = torch.where(mask, sco, -math.inf)
        mc, lc = m[..., qs], l[..., qs]
        m_new = torch.maximum(mc, sco.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(sco - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(mc), torch.exp(mc - m_safe), 0.0)
        l_new = lc * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v[:, ks])
        acc[:, qs] = acc[:, qs] * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m[..., qs] = m_new
        l[..., qs] = l_new
    return acc, m, l


def _flash_forward(qg, k, v, *, causal, chunk, window):
    """Online-softmax block attention forward. Returns (out, lse)."""
    s = qg.shape[1]
    t = s // chunk
    pairs = _pair_lists(t, chunk, causal, window)
    acc, m, l = _online_softmax(
        qg, k, v, pairs, chunk,
        lambda i, j: _pair_mask(i, j, chunk, causal, window, qg.device))
    l_safe = torch.clamp(l, min=1e-20)
    out = (acc / l_safe.permute(0, 3, 1, 2)[..., None]).to(qg.dtype)
    lse = torch.where(l > 0, torch.where(torch.isfinite(m), m, 0.0)
                      + torch.log(l_safe), -math.inf)
    return out, lse                     # lse: (b, hkv, g, s)


def _flash_offset_fwd(qg, k, v, off: int, *, causal, chunk, window):
    """Flash forward where the q rows sit at global offset `off` into the
    kv context (a context-parallel shard): the pair grid is the full
    (s_q/chunk x s_kv/chunk) rectangle, causality a mask."""
    t_q, t_kv = qg.shape[1] // chunk, k.shape[1] // chunk
    pairs = [(i, j) for i in range(t_q) for j in range(t_kv)]
    acc, _, l = _online_softmax(
        qg, k, v, pairs, chunk,
        lambda i, j: _pair_mask(i, j, chunk, causal, window, qg.device, off))
    l_safe = torch.clamp(l, min=1e-20)
    return (acc / l_safe.permute(0, 3, 1, 2)[..., None]).to(qg.dtype)


def attention_chunked(q, k, v, *, causal: bool, chunk: int, ctx=None,
                      window: int = 0):
    """Flash-style block attention (the forward of the reference's
    custom-VJP flash attention)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if s % chunk:
        raise ValueError(f"context {s} is not a multiple of chunk {chunk}")
    qg = q.reshape(b, s, hkv, g, d)
    out, _ = _flash_forward(qg, k, v, causal=causal, chunk=chunk,
                            window=window)
    return out.reshape(b, s, hq, d)


def attention_seqpar(q, k, v, *, causal: bool, chunk: int, ctx,
                     window: int = 0):
    """Context-parallel attention for archs whose head counts do not divide
    the TP axis: q splits over the context dim into the ctx's tp shards,
    K/V stay whole, and each shard runs the offset flash scan over its q
    rows against the whole context."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    tp = ctx.tp_size
    s_local = s // tp
    c = min(chunk, s_local)
    outs = []
    for r in range(tp):
        qb = q[:, r * s_local:(r + 1) * s_local]
        qg = qb.reshape(b, s_local, hkv, g, d)
        o = _flash_offset_fwd(qg, k, v, r * s_local, causal=causal, chunk=c,
                              window=window)
        outs.append(o.reshape(b, s_local, hq, d))
    return torch.cat(outs, dim=1)


def attention(q, k, v, *, causal: bool, chunk: int = 0, ctx=None,
              window: int = 0):
    s = q.shape[1]
    if (ctx is not None and not ctx.shard_heads and ctx.tp_size > 1
            and s % ctx.tp_size == 0 and s >= 2 * ctx.tp_size
            and k.shape[1] == s):
        return attention_seqpar(q, k, v, causal=causal, chunk=chunk or s,
                                ctx=ctx, window=window)
    if chunk and s > chunk and s % chunk == 0:
        return attention_chunked(q, k, v, causal=causal, chunk=chunk, ctx=ctx,
                                 window=window)
    # indivisible contexts (e.g. whisper's 1500-frame encoder) take the
    # full-einsum path
    return attention_full(q, k, v, causal=causal, ctx=ctx, window=window)


def decode_attention(q, k_cache, v_cache, q_pos, *, ctx=None, window: int = 0,
                     ring_pos=None):
    """Attention of q tokens at absolute positions q_pos (Sq,) against a
    (B, Smax, Hkv, D) cache whose entries <= q_pos are valid.
    ring_pos (int): the cache is a ring buffer whose slots all hold
    in-window positions once warm; mask only unwritten slots."""
    b, sq, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    ki = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    if ring_pos is not None:
        mask = ki <= int(ring_pos)
    else:
        qp = torch.as_tensor(q_pos, device=q.device).reshape(-1)[:, None]
        mask = ki <= qp
        if window:
            mask = mask & (ki > qp - window)
    o = _sdpa(qg, k_cache, v_cache, mask[None, None, None],
              1.0 / math.sqrt(d))
    return o.reshape(b, sq, hq, d)


def swiglu(x, w1, w3, w2, ctx=None):
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


def attn_block(x, p, *, positions, cfg, ctx, cache=None, pos=None,
               kv_override=None, causal=True):
    """Pre-norm attention block. Returns (residual output, new_kv).

    cache: optional (k_cache, v_cache) for prefill/decode, written in
    place; kv_override: raw encoder states to project (cross-attention).
    """
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    b, s, d = h.shape
    hd = cfg.head_dim
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    src = h if kv_override is None else kv_override
    k = (src @ p["wk"]).reshape(b, src.shape[1], cfg.n_kv_heads, hd)
    v = (src @ p["wv"]).reshape(b, src.shape[1], cfg.n_kv_heads, hd)
    if kv_override is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    def expand_kv(k, v):
        """Under head-sharded TP with kv_heads % tp != 0, repeat KV up to
        Hq (Megatron GQA expansion), as the reference does."""
        tp = ctx.tp_size if ctx is not None else 1
        if ctx is None or not ctx.shard_heads or tp <= 1 or \
                cfg.n_kv_heads % tp == 0:
            return k, v
        rep = cfg.n_heads // cfg.n_kv_heads
        return (torch.repeat_interleave(k, rep, dim=2),
                torch.repeat_interleave(v, rep, dim=2))

    new_kv = None
    if cache is not None:                      # decode/prefill with cache
        k_cache, v_cache = cache
        # window-sized cache => ring buffer semantics (see init_cache)
        ring = bool(cfg.attn_window) and k_cache.shape[1] == cfg.attn_window
        if ring:
            w = cfg.attn_window
            if s > 1:    # prefill: keep the last `w` positions (s % w == 0)
                if s >= w:
                    k_cache, v_cache = k[:, -w:], v[:, -w:]
                else:
                    update_slice(k_cache, k, pos, 1)
                    update_slice(v_cache, v, pos, 1)
            else:
                slot = int(pos) % w
                update_slice(k_cache, k, slot, 1)
                update_slice(v_cache, v, slot, 1)
        else:
            update_slice(k_cache, k, pos, 1)
            update_slice(v_cache, v, pos, 1)
        new_kv = (k_cache, v_cache)
        if s > 1:
            # prefill: attend over the fresh K/V with the flash path
            # (an empty cache below `pos`, i.e. pos == 0)
            ke, ve = expand_kv(k, v)
            o = attention(q, ke, ve, causal=True, chunk=cfg.attn_chunk,
                          ctx=ctx, window=cfg.attn_window)
        elif ring:
            # all ring slots hold positions in (pos - w, pos]; mask only the
            # not-yet-written slots during warmup
            o = decode_attention(q, k_cache, v_cache, positions, ctx=ctx,
                                 window=0, ring_pos=pos)
        else:
            o = decode_attention(q, k_cache, v_cache, positions, ctx=ctx,
                                 window=cfg.attn_window)
    elif kv_override is not None:              # cross-attention
        ke, ve = expand_kv(k, v)
        o = attention_full(q, ke, ve, causal=False, ctx=ctx)
        new_kv = (k, v)
    else:
        ke, ve = expand_kv(k, v)
        o = attention(q, ke, ve, causal=causal, chunk=cfg.attn_chunk, ctx=ctx,
                      window=cfg.attn_window)
        new_kv = (k, v)
    o = o.reshape(b, s, cfg.q_dim)
    return x + o @ p["wo"], new_kv


def mlp_block(x, p, cfg, ctx, d_ff=None):
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    return x + swiglu(h, p["w1"], p["w3"], p["w2"], ctx)
