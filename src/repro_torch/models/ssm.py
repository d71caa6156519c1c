"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Counterpart of `repro.models.ssm`. Chunked SSD: within a chunk of Q
timesteps the recurrence is a masked attention-like matmul; across chunks
a short sequential loop carries the (H, hd, n) state. Decode is the O(1)
recurrent update on the persistent (B, H, hd, n) state plus a rolling
causal-conv window.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rmsnorm
from repro_torch.sort.api import resolve_device


def _segsum(a):
    """a: (..., Q). Returns (..., Q, Q): sum_{j<i..} with -inf above diag."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=a.device)[:, None]
    j = torch.arange(q, device=a.device)[None, :]
    return torch.where(i >= j, diff, -math.inf)


def causal_conv(x, w, cache=None):
    """Depthwise causal conv. x: (B, L, C); w: (W, C); cache: (B, W-1, C)."""
    width = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    new_cache = xp[:, -(width - 1):, :] if width > 1 else pad
    return F.silu(out), new_cache


def ssd_chunked(xh, dt, A_log, B, C, D, *, chunk: int):
    """xh: (b,l,h,p); dt: (b,l,h); A_log: (h,); B/C: (b,l,g,n); D: (h,)."""
    b, l, h, p = xh.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"length {l} is not a multiple of chunk {chunk}")
    c = l // chunk
    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=2)        # (b,l,h,n)
    Ch = torch.repeat_interleave(C, rep, dim=2)

    a = (-torch.exp(A_log.float()))[None, None, :] * dt  # (b,l,h)
    xdt = xh * dt[..., None].to(xh.dtype)

    def ck(t):  # chunk a (b,l,...) tensor to (b,c,Q,...)
        return t.reshape((b, c, chunk) + t.shape[2:])

    a_c = ck(a).permute(0, 3, 1, 2)              # (b,h,c,Q)
    a_cum = torch.cumsum(a_c, dim=-1)            # (b,h,c,Q)
    L = torch.exp(_segsum(a_c))                  # (b,h,c,Q,Q)
    x_c = ck(xdt).float()                        # (b,c,Q,h,p)
    B_c, C_c = ck(Bh).float(), ck(Ch).float()    # (b,c,Q,h,n)

    # intra-chunk (quadratic in Q)
    scores = torch.einsum("bcqhn,bckhn->bhcqk", C_c, B_c)
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", scores * L, x_c)

    # chunk-final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)         # (b,h,c,Q)
    states = torch.einsum("bckhn,bhck,bckhp->bchpn", B_c, decay_states, x_c)

    # inter-chunk recurrence over c (sequential, short)
    chunk_decay = torch.exp(a_cum[..., -1])                   # (b,h,c)
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    s_prevs = []
    for ci in range(c):
        s_prevs.append(s)
        s = s * chunk_decay[:, :, ci, None, None] + states[:, ci]
    s_prevs = torch.stack(s_prevs, dim=1)                     # (b,c,h,p,n)

    state_decay_out = torch.exp(a_cum)                        # (b,h,c,Q)
    y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp", C_c, s_prevs,
                         state_decay_out)
    y = (y_diag + y_off).reshape(b, l, h, p).to(xh.dtype)
    y = y + xh * D[None, None, :, None].to(xh.dtype)
    return y, s


def mamba_block(x, p, cfg, ctx, cache=None):
    """Pre-norm Mamba2 block. cache: dict(conv_x, conv_B, conv_C, state) for
    decode (L dim stripped). Returns (y, new_cache_or_None)."""
    b, l, d = x.shape
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    z = h @ p["wz"]                                  # (b,l,di)
    xi = h @ p["wx"]                                 # (b,l,di)
    Bp = h @ p["wB"]                                 # (b,l,g*n)
    Cp = h @ p["wC"]
    dt = F.softplus((h @ p["wdt"]).float()
                    + p["dt_bias"][None, None, :])    # (b,l,H)

    cx = cache["conv_x"] if cache else None
    cb = cache["conv_B"] if cache else None
    cc = cache["conv_C"] if cache else None
    xi, ncx = causal_conv(xi, p["conv_x"], cx)
    Bp, ncb = causal_conv(Bp, p["conv_B"], cb)
    Cp, ncc = causal_conv(Cp, p["conv_C"], cc)

    H, hd = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    xh = xi.reshape(b, l, H, hd)
    Bm = Bp.reshape(b, l, g, n)
    Cm = Cp.reshape(b, l, g, n)

    if cache is None or l > 1:
        # train or prefill: chunked scan (prefill assumes empty initial state,
        # i.e. pos == 0); the final state seeds subsequent decode steps.
        y, s_last = ssd_chunked(xh, dt, p["A_log"], Bm, Cm, p["D"],
                                chunk=min(cfg.ssm_chunk, l))
        new_cache = None
        if cache is not None:
            new_cache = {"conv_x": ncx, "conv_B": ncb, "conv_C": ncc,
                         "state": s_last}
    else:
        s_prev = cache["state"]                      # (b,H,hd,n) f32
        rep = H // g
        Bh = torch.repeat_interleave(Bm[:, 0], rep, dim=1)   # (b,H,n)
        Ch = torch.repeat_interleave(Cm[:, 0], rep, dim=1)
        a = -torch.exp(p["A_log"].float()) * dt[:, 0]         # (b,H)
        dA = torch.exp(a)[..., None, None]
        dx = (xh[:, 0] * dt[:, 0, :, None]).float()          # (b,H,hd)
        s_new = s_prev * dA + dx[..., :, None] * Bh[:, :, None, :]
        y = torch.einsum("bhpn,bhn->bhp", s_new, Ch.float())
        y = y + xh[:, 0].float() * p["D"][None, :, None]
        y = y[:, None].to(x.dtype)                   # (b,1,H,hd)
        new_cache = {"conv_x": ncx, "conv_B": ncb, "conv_C": ncc,
                     "state": s_new}

    y = y.reshape(b, l, cfg.d_inner)
    y = rmsnorm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = x + y @ p["wout"]
    return out, new_cache


def init_ssm_cache(cfg, batch, dtype, device="cuda", layers=None):
    """Zeroed decode state on `device`; `layers` adds a leading
    stacked-layer axis."""
    device = resolve_device(device)
    lead = () if layers is None else (layers,)
    w = cfg.ssm_conv
    gn = cfg.ssm_groups * cfg.ssm_state

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return {
        "conv_x": zeros(batch, w - 1, cfg.d_inner),
        "conv_B": zeros(batch, w - 1, gn),
        "conv_C": zeros(batch, w - 1, gn),
        "state": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state, dt=torch.float32),
    }
