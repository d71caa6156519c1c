"""Mixture-of-Experts layer with expert parallelism over the tp shards.

Counterpart of `repro.models.moe`. Token dispatch is the paper's problem
at micro scale (DESIGN.md Section 4.1): T tokens are partitioned across
expert shards under a static (1+eps) capacity, with the port's
`repro_torch.sort.grouping.counting_dispatch` (the function the reference
calls: a stable counting sort), packed into per-destination capacity
slots, exchanged in one capacity-padded all_to_all over the ctx's emulated
tp shards (`Comm`), run through the grouped expert FFN, sent back by the
reverse all_to_all and combined at the source. Dropped (over-capacity)
assignments are counted and returned.

Two static paths, chosen by the reference's predicate:
  big-T   (prefill): tokens context-sharded over tp; the all_to_all moves
          only routed activations.
  small-T (decode): tokens replicated over tp; every shard computes its
          local experts for all tokens and the outputs psum-combine.

Two choices keep the port's answer the reference's on the card:
  * routing ranks the experts by a stable descending sort, so exactly
    tied logits pick the lower expert id, as jax.lax.top_k does
    (torch.topk promises no order among ties);
  * the combine carries each token's k contributions back to input order
    by the inverse of the dispatch permutation and sums them over k, with
    no atomics: the sum is the same from run to run (its association
    may differ from XLA's scatter-add for k > 2).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.common import round_up
from repro_torch.models.layers import rmsnorm, swiglu
from repro_torch.sort.grouping import counting_dispatch


def _expert_ffn(buf, w1, w3, w2):
    """buf: (E_local, C, d); w*: (E_local, d, f) / (E_local, f, d)."""
    h = F.silu(torch.bmm(buf, w1))
    h = h * torch.bmm(buf, w3)
    return torch.bmm(h, w2)


def _route(flat, wr, k):
    """-> (gates (t, k) f32, expert ids (t, k) int32, probs (t, E) f32):
    the k largest logits, ties to the lower expert id."""
    logits = (flat @ wr).float()                         # (t, E)
    ranked, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(ranked[:, :k], dim=-1)
    eids = order[:, :k].to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    return gates, eids, probs


def _assignments(t: int, k: int, device):
    """The token of each of the t*k flat (token, choice) items."""
    return torch.arange(t * k, dtype=torch.int64, device=device) // k


def _inverse(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), dtype=order.dtype,
                              device=order.device)
    return inv


def _combine(contrib, order, t: int, k: int):
    """Each token's k contributions, in grouped order, summed in input
    order: (t*k, d) -> (t, d)."""
    return contrib[_inverse(order)].reshape(t, k, -1).sum(dim=1)


def _scatter_rows(rows, slot, n_slots: int, dtype):
    """buf[slot] = rows over n_slots + 1 rows (the last is the overflow
    row, which only zero rows reach)."""
    buf = torch.zeros((n_slots + 1, rows.shape[1]), dtype=dtype,
                      device=rows.device)
    buf[slot] = rows.to(dtype)
    return buf


def _moe_local(flat, wr, w1, w3, w2, *, k, e_local, e0, capacity):
    """Small-T path body of one tp shard: tokens replicated; compute the
    shard's local experts only."""
    t, d = flat.shape
    gates, eids, probs = _route(flat, wr, k)
    flat_e = eids.reshape(-1)
    flat_g = gates.reshape(-1)
    tok = _assignments(t, k, flat.device)
    e_rel = torch.where((flat_e >= e0) & (flat_e < e0 + e_local),
                        flat_e - e0, -1)
    # -1 (non-local) sort first; counting_dispatch treats them as invalid
    order, slot, keep = counting_dispatch(e_rel, e_local, capacity)
    order, slot = order.long(), slot.long()
    rows = flat[tok[order]] * keep[:, None].to(flat.dtype)
    buf = _scatter_rows(rows, slot, e_local * capacity, flat.dtype)
    out_e = _expert_ffn(buf[:-1].reshape(e_local, capacity, d), w1, w3, w2)
    y = torch.cat([out_e.reshape(e_local * capacity, d),
                   out_e.new_zeros((1, d))])
    contrib = y[slot] * (flat_g[order] * keep)[:, None].to(y.dtype)
    out = _combine(contrib, order, t, k)
    dropped = torch.sum((e_rel[order] >= 0) & ~keep, dtype=torch.int32)
    return out, probs, dropped


def _moe_a2a(xs, wr, w1, w3, w2, *, k, ep, e_local, comm, cap1, cap2,
             a2a_dtype=None):
    """Big-T path over the ep = tp shards: xs (ep, t_local, d), each row
    block one shard's context-sharded tokens; w* (E, ...) whole, shard me
    holding experts [me*e_local, (me+1)*e_local). Returns (out (ep,
    t_local, d), probs (ep, t_local, E), dropped (ep,))."""
    _, t, d = xs.shape
    dtype = xs.dtype
    wire = a2a_dtype or dtype
    dev = xs.device
    tok = _assignments(t, k, dev)
    sent, sent_e, routed = [], [], []
    for flat in xs:                      # each source shard: dispatch
        gates, eids, probs = _route(flat, wr, k)
        flat_e = eids.reshape(-1)
        dest = torch.div(flat_e, e_local, rounding_mode="floor")
        order, slot1, keep1 = counting_dispatch(dest, ep, cap1)
        order, slot1 = order.long(), slot1.long()
        rows = flat[tok[order]] * keep1[:, None].to(dtype)
        send = _scatter_rows(rows, slot1, ep * cap1, wire)
        send_e = torch.full((ep * cap1 + 1,), -1, dtype=torch.int32,
                            device=dev)
        send_e[slot1] = torch.where(keep1, flat_e[order], -1)
        sent.append(send[:-1].reshape(ep, cap1, d))
        sent_e.append(send_e[:-1].reshape(ep, cap1, 1))
        routed.append((gates.reshape(-1), probs, order, slot1, keep1))
    recv = comm.all_to_all(torch.stack(sent)).reshape(ep, ep * cap1, d)
    recv = recv.to(dtype)
    recv_e = comm.all_to_all(torch.stack(sent_e)).reshape(ep, ep * cap1)

    back, drop2 = [], []
    for me in range(ep):                 # each expert shard: the FFN
        e_rel = torch.where(recv_e[me] >= 0, recv_e[me] - me * e_local, -1)
        order2, slot2, keep2 = counting_dispatch(e_rel, e_local, cap2)
        order2, slot2 = order2.long(), slot2.long()
        rows2 = recv[me][order2] * keep2[:, None].to(dtype)
        buf = _scatter_rows(rows2, slot2, e_local * cap2, dtype)
        mine = slice(me * e_local, (me + 1) * e_local)
        out_e = _expert_ffn(buf[:-1].reshape(e_local, cap2, d), w1[mine],
                            w3[mine], w2[mine])
        y = torch.cat([out_e.reshape(e_local * cap2, d),
                       out_e.new_zeros((1, d))])
        # back to received-slot order, then the reverse all_to_all
        y_recv = torch.zeros((ep * cap1, d), dtype=wire, device=dev)
        y_recv[order2] = (y[slot2] * keep2[:, None].to(y.dtype)).to(wire)
        back.append(y_recv.reshape(ep, cap1, d))
        drop2.append(torch.sum((e_rel[order2] >= 0) & ~keep2,
                               dtype=torch.int32))
    homes = comm.all_to_all(torch.stack(back)).reshape(ep, ep * cap1, d)

    outs, probs_all, dropped = [], [], []
    for src, (flat_g, probs, order, slot1, keep1) in enumerate(routed):
        y_home = torch.cat([homes[src].to(dtype), xs.new_zeros((1, d))])
        contrib = y_home[slot1] * (flat_g[order] * keep1)[:, None].to(dtype)
        outs.append(_combine(contrib, order, t, k))
        probs_all.append(probs)
        dropped.append(torch.sum(~keep1, dtype=torch.int32) + drop2[src])
    return torch.stack(outs), torch.stack(probs_all), torch.stack(dropped)


def _dtype(name: str):
    return getattr(torch, name) if name else None


def moe_ffn(x, p, cfg, ctx):
    """x: (B, S, d). Returns (y, aux) where aux carries router stats."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    tp = ctx.tp_size
    ep = tp
    e_local = E // ep
    t_global = b * s
    big = s % tp == 0 and s >= tp and t_global // (ctx.dp_size * tp) >= 1 and s > 1
    comm = ctx.comm()

    if big:
        t_local = t_global // (ctx.dp_size * tp)
        cap1 = round_up(int(math.ceil(t_local * k / ep * cfg.moe_capacity_factor)), 8)
        cap2 = round_up(int(math.ceil(t_local * k / e_local * cfg.moe_capacity_factor)), 8)
    else:
        # decode (weights-stationary): tokens replicate everywhere, the
        # expert weights stay in their shards; partial outputs psum
        t_local = t_global
        cap2 = round_up(int(math.ceil(t_local * k / e_local
                                      * cfg.moe_capacity_factor)), 8)
        cap2 = min(cap2, round_up(t_local * k, 8))
        cap1 = 0

    # moe_gather_dtype: the weights cross the reference's FSDP gather in
    # that dtype (big-T) and compute in the config's
    gdt, cdt = _dtype(cfg.moe_gather_dtype), _dtype(cfg.dtype)
    w1, w3, w2 = p["w1"], p["w3"], p["w2"]
    if gdt is not None:
        if big:
            w1, w3, w2 = w1.to(gdt), w3.to(gdt), w2.to(gdt)
        w1, w3, w2 = w1.to(cdt), w3.to(cdt), w2.to(cdt)

    if big:
        sl = s // tp
        xs = x.reshape(b, tp, sl, d).transpose(0, 1).reshape(tp, b * sl, d)
        out, probs, dropped = _moe_a2a(
            xs, p["router"], w1, w3, w2, k=k, ep=ep, e_local=e_local,
            comm=comm, cap1=cap1, cap2=cap2,
            a2a_dtype=_dtype(cfg.moe_a2a_dtype))
        y = out.reshape(tp, b, sl, d).transpose(0, 1).reshape(b, s, d)
    else:
        flat = x.reshape(-1, d)
        parts = []
        for me in range(tp):
            mine = slice(me * e_local, (me + 1) * e_local)
            parts.append(_moe_local(
                flat, p["router"], w1[mine], w3[mine], w2[mine], k=k,
                e_local=e_local, e0=me * e_local, capacity=cap2))
        out, probs, dropped = (torch.stack(v) for v in zip(*parts))
        # combine the expert-parallel partial sums
        y = comm.psum(out).reshape(x.shape)
    # replicated stats: the mean router prob per expert and the global drops
    mean_prob = comm.pmean(probs.mean(dim=1))
    dropped = comm.psum(dropped)
    if not big:
        dropped = dropped // max(ctx.dp_size, 1)
    return y, {"router_mean_prob": mean_prob, "dropped": dropped}


def moe_block(x, p, cfg, ctx):
    """Pre-norm MoE block with optional shared experts."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    y, aux = moe_ffn(h, p, cfg, ctx)
    if cfg.n_shared_experts:
        y = y + swiglu(h, p["shared_w1"], p["shared_w3"], p["shared_w2"], ctx)
    return x + y, aux
