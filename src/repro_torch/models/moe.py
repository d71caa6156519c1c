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

The ctx's dp x tp grid is emulated on one device: every shard's value is
a row of one tensor (`ctx.comm()`, shard g*tp + j), and each step runs on
all rows at once. Two static paths, chosen by the reference's predicate:
  big-T   (train/prefill): the batch splits into dp groups (B % dp == 0,
          as the reference's shard_map needs) and each group's context
          into its tp shards; each capacity is cut for one shard's
          t_global / (dp * tp) tokens, and the all_to_all runs within each
          dp group, moving only routed activations.
  small-T (decode): tokens replicated on every shard; shard (g, j)
          computes tp shard j's experts on part g of their d_ff (the
          weights stay where FSDP stores them), and the partial outputs
          psum over the whole grid. Every dp shard counts the same drops,
          so the sum is divided by dp.

Three choices keep the port's answer the reference's on the card:
  * routing ranks the experts by a stable descending sort, so exactly
    tied logits pick the lower expert id, as jax.lax.top_k does
    (torch.topk promises no order among ties);
  * the combine carries each token's k contributions back to input order
    by the inverse of the dispatch permutation and sums them over k, with
    no atomics: the sum is the same from run to run (its association
    may differ from XLA's scatter-add for k > 2);
  * the decode path's dp x tp partial outputs (each in the compute dtype,
    bf16 in production) are added by one reduction over the grid's
    leading axis (`Comm.psum`, torch's `sum`), the reference's by its
    all-reduce; in bf16 the two associations may differ in the last bit.
    The fp8 gather dtype only changes a layout in the reference: the port
    keeps its cast order (to the gather dtype, then to the compute one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.common import round_up
from repro_torch.models.layers import rmsnorm, swiglu
from repro_torch.sort.grouping import counting_dispatch


def _expert_ffn(buf, w1, w3, w2):
    """buf: (..., E_local, C, d); w*: (..., E_local, d, f) / (...,
    E_local, f, d)."""
    h = F.silu(torch.matmul(buf, w1))
    h = h * torch.matmul(buf, w3)
    return torch.matmul(h, w2)


def _route(flat, wr, k):
    """-> (gates (..., t, k) f32, expert ids (..., t, k) int32, probs
    (..., t, E) f32): the k largest logits, ties to the lower expert id."""
    logits = (flat @ wr).float()                         # (..., t, E)
    ranked, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(ranked[..., :k], dim=-1)
    eids = order[..., :k].to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    return gates, eids, probs


def _rows(src, idx):
    """src (G, n, d) gathered at idx (G, m) along its rows -> (G, m, d)."""
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[-1]))


def _combine(contrib, order, k: int):
    """Each token's k contributions, in grouped order, summed in input
    order: (G, t*k, d) -> (G, t, d)."""
    g, n, d = contrib.shape
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(n, dtype=order.dtype,
                                        device=order.device).expand(g, n))
    return _rows(contrib, inv).reshape(g, n // k, k, d).sum(dim=2)


def _scatter_rows(rows, slot, n_slots: int, dtype):
    """buf[g, slot[g]] = rows[g] over n_slots + 1 rows a shard (the last is
    the overflow row, which only zero rows reach)."""
    g, _, d = rows.shape
    buf = torch.zeros((g, n_slots + 1, d), dtype=dtype, device=rows.device)
    buf.scatter_(1, slot[..., None].expand(-1, -1, d), rows.to(dtype))
    return buf


def _dispatch(ids, n_groups: int, capacity: int):
    """counting_dispatch on each row of ids (G, n): (order, slot) int64
    and keep."""
    order, slot, keep = counting_dispatch(ids, n_groups, capacity)
    return order.long(), slot.long(), keep


def _grid_ffn(buf, w1, w3, w2):
    """buf (dp, ep, e_local, C, d) through tp shard j's experts (w*
    (ep, e_local, ...)) in every dp group: the dp groups fold into the
    rows, so no weight is copied."""
    dp, ep, el, c, d = buf.shape
    rows = buf.permute(1, 2, 0, 3, 4).reshape(ep, el, dp * c, d)
    out = _expert_ffn(rows, w1, w3, w2)
    return out.reshape(ep, el, dp, c, d).permute(2, 0, 1, 3, 4)


def _split_ffn(buf, w1, w3, w2, dp: int):
    """buf (tp, e_local, C, d) through each tp shard's experts, their d_ff
    split into dp parts: -> the (dp*tp, e_local, C, d) partial products
    of shard (g, j) = tp shard j's experts on d_ff columns [g*f, (g+1)*f).
    The silu gate is elementwise in d_ff, so the parts sum to the whole."""
    tp, el, c, d = buf.shape
    ff = w1.shape[-1]
    h = F.silu(torch.matmul(buf, w1.reshape(tp, el, d, ff)))
    h = h * torch.matmul(buf, w3.reshape(tp, el, d, ff))
    h = h.reshape(tp, el, c, dp, ff // dp).transpose(2, 3)
    out = torch.matmul(h, w2.reshape(tp, el, dp, ff // dp, d))
    return out.permute(2, 0, 1, 3, 4).reshape(dp * tp, el, c, d)


def _moe_local(flat, wr, w1, w3, w2, *, k, tp, dp, e_local, capacity):
    """Small-T path over the dp x tp grid: tokens replicated on every
    shard, shard (g, j) computing tp shard j's experts on dp part g of
    their d_ff. w* (E, d, f) / (E, f, d) whole. Returns the per-shard
    partial outputs (dp*tp, t, d), probs (dp*tp, t, E) and drops
    (dp*tp,)."""
    t, d = flat.shape
    dev = flat.device
    gates, eids, probs = _route(flat, wr, k)
    flat_e = eids.reshape(1, -1)
    flat_g = gates.reshape(1, -1)
    tok = torch.arange(t * k, device=dev) // k
    e0 = torch.arange(tp, device=dev)[:, None] * e_local
    e_rel = torch.where((flat_e >= e0) & (flat_e < e0 + e_local),
                        flat_e - e0, -1)                 # (tp, t*k)
    # -1 (non-local) sort first; counting_dispatch treats them as invalid
    order, slot, keep = _dispatch(e_rel, e_local, capacity)
    rows = flat[tok[order]] * keep[..., None].to(flat.dtype)
    buf = _scatter_rows(rows, slot, e_local * capacity, flat.dtype)
    buf = buf[:, :-1].reshape(tp, e_local, capacity, d)
    out_e = _split_ffn(buf, w1, w3, w2, dp)      # (dp*tp, e_local, C, d)
    y = torch.cat([out_e.reshape(dp * tp, e_local * capacity, d),
                   out_e.new_zeros((dp * tp, 1, d))], dim=1)
    grid = lambda v: v.repeat((dp,) + (1,) * (v.dim() - 1))
    order, slot, keep = grid(order), grid(slot), grid(keep)
    gate = torch.gather(flat_g.expand(dp * tp, -1), 1, order)
    contrib = _rows(y, slot) * (gate * keep)[..., None].to(y.dtype)
    out = _combine(contrib, order, k)
    dropped = torch.sum((torch.gather(grid(e_rel), 1, order) >= 0) & ~keep,
                        dim=1, dtype=torch.int32)
    return out, probs.expand(dp * tp, -1, -1), dropped


def _moe_a2a(xs, wr, w1, w3, w2, *, k, ep, e_local, comm, cap1, cap2,
             a2a_dtype=None):
    """Big-T path over the dp x tp grid (ep = tp): xs (dp*ep, t_local, d),
    row s = g*ep + j shard j of dp group g holding its context-sharded
    tokens; w* (E, ...) whole, tp shard j holding experts [j*e_local,
    (j+1)*e_local). Each dp group exchanges among its own ep shards.
    Returns (out (dp*ep, t_local, d), probs (dp*ep, t_local, E), dropped
    (dp*ep,))."""
    n_shards, t, d = xs.shape
    dp = n_shards // ep
    dtype = xs.dtype
    wire = a2a_dtype or dtype
    dev = xs.device
    tok = (torch.arange(t * k, device=dev) // k).expand(n_shards, -1)
    # each source shard: route and dispatch to the ep shards of its group
    gates, eids, probs = _route(xs, wr, k)
    flat_e = eids.reshape(n_shards, -1)
    flat_g = gates.reshape(n_shards, -1)
    dest = torch.div(flat_e, e_local, rounding_mode="floor")
    order, slot1, keep1 = _dispatch(dest, ep, cap1)
    rows = _rows(xs, torch.gather(tok, 1, order)) * keep1[..., None].to(dtype)
    send = _scatter_rows(rows, slot1, ep * cap1, wire)
    send_e = torch.full((n_shards, ep * cap1 + 1), -1, dtype=torch.int32,
                        device=dev)
    send_e.scatter_(1, slot1, torch.where(keep1, torch.gather(flat_e, 1,
                                                              order), -1))
    recv = comm.all_to_all(send[:, :-1].reshape(n_shards, ep, cap1, d))
    recv = recv.reshape(n_shards, ep * cap1, d).to(dtype)
    recv_e = comm.all_to_all(send_e[:, :-1].reshape(n_shards, ep, cap1, 1))
    recv_e = recv_e.reshape(n_shards, ep * cap1)

    # each expert shard: its local experts' FFN
    me = (torch.arange(n_shards, device=dev) % ep)[:, None]
    e_rel = torch.where(recv_e >= 0, recv_e - me * e_local, -1)
    order2, slot2, keep2 = _dispatch(e_rel, e_local, cap2)
    rows2 = _rows(recv, order2) * keep2[..., None].to(dtype)
    buf = _scatter_rows(rows2, slot2, e_local * cap2, dtype)
    buf = buf[:, :-1].reshape(dp, ep, e_local, cap2, d)
    out_e = _grid_ffn(buf, w1.reshape(ep, e_local, *w1.shape[1:]),
                      w3.reshape(ep, e_local, *w3.shape[1:]),
                      w2.reshape(ep, e_local, *w2.shape[1:]))
    y = torch.cat([out_e.reshape(n_shards, e_local * cap2, d),
                   out_e.new_zeros((n_shards, 1, d))], dim=1)
    # back to received-slot order, then the reverse all_to_all
    y_recv = torch.zeros((n_shards, ep * cap1, d), dtype=wire, device=dev)
    y_recv.scatter_(1, order2[..., None].expand(-1, -1, d),
                    (_rows(y, slot2) * keep2[..., None].to(y.dtype)).to(wire))
    homes = comm.all_to_all(y_recv.reshape(n_shards, ep, cap1, d))
    drop2 = torch.sum((torch.gather(e_rel, 1, order2) >= 0) & ~keep2, dim=1,
                      dtype=torch.int32)

    # each source shard: combine what came home
    y_home = torch.cat([homes.reshape(n_shards, ep * cap1, d).to(dtype),
                        xs.new_zeros((n_shards, 1, d))], dim=1)
    contrib = _rows(y_home, slot1) * (torch.gather(flat_g, 1, order)
                                      * keep1)[..., None].to(dtype)
    out = _combine(contrib, order, k)
    dropped = torch.sum(~keep1, dim=1, dtype=torch.int32) + drop2
    return out, probs, dropped


def _dtype(name: str):
    return getattr(torch, name) if name else None


def moe_ffn(x, p, cfg, ctx):
    """x: (B, S, d). Returns (y, aux) where aux carries router stats."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    tp, dp = ctx.tp_size, ctx.dp_size
    ep = tp
    e_local = E // ep
    t_global = b * s
    big = s % tp == 0 and s >= tp and t_global // (dp * tp) >= 1 and s > 1
    comm = ctx.comm()

    if big:
        if b % dp:
            raise ValueError(f"batch {b} does not split into dp={dp} groups")
        t_local = t_global // (dp * tp)
        cap1 = round_up(int(math.ceil(t_local * k / ep * cfg.moe_capacity_factor)), 8)
        cap2 = round_up(int(math.ceil(t_local * k / e_local * cfg.moe_capacity_factor)), 8)
    else:
        # decode (weights-stationary): tokens replicate everywhere, the
        # expert weights stay in their shards; partial outputs psum
        if p["w1"].shape[-1] % dp:
            raise ValueError(f"d_ff {p['w1'].shape[-1]} does not split into "
                             f"dp={dp} parts")
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
        sl, bl = s // tp, b // dp
        # shard (g, j) holds batch rows [g*bl, (g+1)*bl), context slice j
        xs = x.reshape(dp, bl, tp, sl, d).transpose(1, 2).reshape(
            dp * tp, bl * sl, d)
        out, probs, dropped = _moe_a2a(
            xs, p["router"], w1, w3, w2, k=k, ep=ep, e_local=e_local,
            comm=comm, cap1=cap1, cap2=cap2,
            a2a_dtype=_dtype(cfg.moe_a2a_dtype))
        y = out.reshape(dp, tp, bl, sl, d).transpose(1, 2).reshape(b, s, d)
    else:
        out, probs, dropped = _moe_local(
            x.reshape(-1, d), p["router"], w1, w3, w2, k=k, tp=tp, dp=dp,
            e_local=e_local, capacity=cap2)
        # combine the expert-parallel and the partial-d_ff sums
        y = comm.psum(out).reshape(x.shape)
    # replicated stats: the mean router prob per expert and the global drops
    mean_prob = comm.pmean(probs.mean(dim=1))
    dropped = comm.psum(dropped)
    if not big:
        # every dp shard counts the same drops
        dropped = dropped // max(dp, 1)
    return y, {"router_mean_prob": mean_prob, "dropped": dropped}


def moe_block(x, p, cfg, ctx):
    """Pre-norm MoE block with optional shared experts."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    y, aux = moe_ffn(h, p, cfg, ctx)
    if cfg.n_shared_experts:
        y = y + swiglu(h, p["shared_w1"], p["shared_w3"], p["shared_w2"], ctx)
    return x + y, aux
