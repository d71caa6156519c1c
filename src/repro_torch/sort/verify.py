"""The fused output audit of the sort pipeline (counterpart of
repro.sort.verify; DESIGN.md Sec. 9).

`audited(sort_fn)` wraps the shard-level pipeline of
`driver.run_batched` with a postcondition audit over the same (p, B, ...)
rows, so single and batched sorts share one code path (a single sort is
B = 1). Per request it checks:

  * the multiset fingerprint: an order-independent keyed hash-sum of the
    encoded keys, input against output. Each key adds mix32(key ^ seed_l)
    to lane l; lanes are summed mod 2^32 and psum-reduced, so equal
    multisets give equal lanes however the keys moved between shards.
    "cheap" keeps 2 lanes, "full" 4. On the tagged path the hashed word is
    the packed (key << b) | index, so the fingerprint covers the pairs;
  * count conservation: the psum of the shards' valid counts must equal
    the padded request length;
  * per-shard sortedness: adjacent-pair violations in each valid prefix;
  * cross-shard order: one ppermute sends each shard's last valid key to
    its successor, and the splitter range check ([s_{i-1}, s_i) under the
    exchange's searchsorted-left slicing) closes the hole an empty shard
    leaves. Multistage publishes no splitters, so it all_gathers the edge
    keys instead and checks each first key against the running maximum of
    the earlier shards' last keys.

The audit vector is (B, 2L+4) uint32 words, held as int64 in [0, 2^32)
on the device, since torch has little uint32 arithmetic: every product and
every sum is masked to 32 bits, so each word equals the reference's
wraparound uint32 word. `finalize` is its one device-to-host copy per
audited launch.

The words hashed are the reference's: the port encodes untagged uint32
keys as int32 with the top bit flipped (repro_torch.core.tagging), where
the reference keeps them uint32, so the audit flips that bit back before
it hashes (`flip`). Everything else is the same encoding in both.

Collision bound: a corruption escapes lane l only if the hash-sums
collide, about 2^-32 per lane; the structural checks are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.common import hi_sentinel, lo_sentinel
from repro_torch.runtime.syncs import sync_site

TIERS = ("off", "cheap", "full")
_LANES = {"cheap": 2, "full": 4}
_GOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF
_TOP = 0x80000000


class VerificationError(RuntimeError):
    """The audit rejected a sort output and the on_verify_failure policy
    could not recover. Carries the AuditReport."""

    def __init__(self, msg: str, report: "AuditReport | None" = None):
        super().__init__(msg)
        self.report = report


class BatchVerificationError(VerificationError):
    """A batched audit failed: carries the decoded BatchedSortOutput and
    the per-row verdicts, so a caller can serve the rows that verified."""

    def __init__(self, msg: str, report: "AuditReport", output):
        super().__init__(msg, report)
        self.output = output
        self.row_ok = np.atleast_1d(report.row_ok)


class ImbalanceError(RuntimeError):
    """The partition-quality SLO was missed and neither duplicate tagging
    nor bonus refinement brought achieved_imbalance under it."""

    def __init__(self, msg: str, achieved: float, slo: float):
        super().__init__(msg)
        self.achieved = achieved
        self.slo = slo


def lanes_for(tier: str) -> int:
    return _LANES[tier]


def audit_width(tier: str) -> int:
    """uint32 words per request in the audit vector."""
    return 2 * lanes_for(tier) + 4


def _mix32(v: torch.Tensor, seed: int) -> torch.Tensor:
    """The fmix32 finalizer under a lane seed, on int64 words in [0,
    2^32): each product wraps mod 2^64 and is masked to its low 32 bits,
    which are the uint32 product's."""
    v = v ^ (seed & _M32)
    v = ((v ^ (v >> 16)) * 0x85EBCA6B) & _M32
    v = ((v ^ (v >> 13)) * 0xC2B2AE35) & _M32
    return v ^ (v >> 16)


def _words(x: torch.Tensor, flip: bool):
    """(lo, hi) 32-bit words of each key as int64 in [0, 2^32); hi is None
    for keys of 4 bytes. `flip` XORs the top bit of 32-bit keys."""
    if x.dtype.itemsize == 8:
        x = x.to(torch.int64)
        return x & _M32, (x >> 32) & _M32
    lo = x.to(torch.int64) & _M32
    return (lo ^ _TOP if flip else lo), None


def fingerprint_lanes(x: torch.Tensor, n_lanes: int, mask=None,
                      flip: bool = False) -> torch.Tensor:
    """Keyed multiset fingerprint of the last axis of x: (..., L) int64
    lanes in [0, 2^32), each the uint32 wraparound hash-sum of the
    reference's lane. 8-byte words hash as two mixed 32-bit halves. `mask`
    (broadcasting against x) keeps only the keys where it is true."""
    lo, hi = _words(x, flip)
    lanes = []
    for lane in range(n_lanes):
        seed = (0xA0761D64 + _GOLD * lane) & _M32
        h = _mix32(lo, seed)
        if hi is not None:
            h = (h + _mix32(hi, seed ^ 0x85EBCA77) * 0x27D4EB2F) & _M32
        if mask is not None:
            h = torch.where(mask, h, 0)
        lanes.append(h.sum(dim=-1) & _M32)
    return torch.stack(lanes, dim=-1)


def _edges(out: torch.Tensor, n_valid: torch.Tensor):
    """Each row's (first, last) valid key; an empty row gives the vacuous
    (hi, lo) sentinel pair. out (..., cap), n_valid (...)."""
    last_at = torch.gather(out, -1, torch.clamp(n_valid - 1, min=0)
                           .to(torch.int64)[..., None])[..., 0]
    first = torch.where(n_valid > 0, out[..., 0], hi_sentinel(out.dtype))
    last = torch.where(n_valid > 0, last_at, lo_sentinel(out.dtype))
    return first, last


def _boundary_viol(out, n_valid, me, comm, grid: bool) -> torch.Tensor:
    """Each shard's boundary violations, (p, B): one ppermute of the last
    keys (`grid` False), or multistage's all_gather of them and a running
    maximum (`grid` True)."""
    p = comm.p
    first, last = _edges(out, n_valid)
    if not grid:
        prev_last = comm.ppermute(last, [(i, i + 1) for i in range(p - 1)])
        bad = (me > 0)[:, None] & (prev_last > first)
    else:
        lasts = comm.all_gather(last)                         # (p, B)
        prefix = torch.cummax(lasts, dim=0).values
        prev_max = prefix[torch.clamp(me - 1, min=0)]
        bad = (me > 0)[:, None] & (first < prev_max)
    return bad.to(torch.int64)


def _range_viol(out, valid, keys, me, p: int) -> torch.Tensor:
    """The splitter-range check, (p, B): shard i holds keys in [s_{i-1},
    s_i) (the last shard unbounded above, so sentinel pads pass). keys
    (B, p-1); empty for multistage, which then checks nothing here."""
    if keys.shape[-1] == 0:
        return torch.zeros(out.shape[:2], dtype=torch.int64,
                           device=out.device)
    lo = torch.where((me > 0)[:, None],
                     keys[:, torch.clamp(me - 1, min=0)].T,
                     lo_sentinel(out.dtype))                  # (p, B)
    hi = keys[:, torch.clamp(me, max=p - 2)].T
    bad = (out < lo[..., None]) | (
        (me < p - 1)[:, None, None] & (out >= hi[..., None]))
    return (bad & valid).sum(dim=-1)


def _port_word(key, dtype: torch.dtype, flip: bool) -> int:
    """`corrupt_key` as the reference casts it into its key dtype, then in
    the port's encoding of that dtype (two's complement of its width)."""
    bits = 8 * dtype.itemsize
    w = int(key) & ((1 << bits) - 1)
    if flip:
        w ^= _TOP
    return w - (1 << bits) if w >> (bits - 1) else w


def _apply_corrupt(out, local, n_valid, me, comm, corrupt, flip: bool):
    """The chaos `corrupt_at` seam: XOR `corrupt_bit` into the first key
    of the LAST shard (never empty: the global maximum routes there) for
    every armed row. With a corrupt_key only rows whose input holds it are
    flipped, found with one psum more (every word masked, as all psums
    here are integer counts)."""
    bit, key = corrupt
    p, batch = out.shape[:2]
    if key is None:
        hit = torch.ones((batch,), dtype=torch.bool, device=out.device)
    else:
        present = (local == _port_word(key, local.dtype, flip)).any(dim=-1)
        hit = comm.psum(present.to(torch.int64)) > 0
    do = (me == p - 1)[:, None] & hit[None] & (n_valid > 0)
    bits = 8 * out.dtype.itemsize
    word = 1 << bit
    word = word - (1 << bits) if word >> (bits - 1) else word
    out = out.clone()
    out[..., 0] ^= torch.where(do, word, 0).to(out.dtype)
    return out


def audited(sort_fn, *, tier: str, grid: bool = False, corrupt=None,
            flip: bool = False):
    """Wrap a shard-level `sort_fn(rows, comm, draws)` of
    `driver.run_batched` with the fused audit. The wrapper's stats slot
    becomes `(stats, audit_vec)`, audit_vec (B, 2L+4) int64 words in [0,
    2^32), psum-reduced:

        [0:L]    input fingerprint lanes     [2L]    output key count
        [L:2L]   output fingerprint lanes    [2L+1]  sortedness violations
                                             [2L+2]  boundary violations
                                             [2L+3]  range violations

    `grid` picks multistage's boundary form; `corrupt` is
    `chaos.corrupt_now()`'s (bit, key) or None; `flip` hashes int32 words
    with the top bit flipped (untagged uint32 keys)."""
    nl = lanes_for(tier)

    def wrapped(local, comm, draws):
        out, n_valid, keys, ranks, ovf, stats = sort_fn(local, comm, draws)
        me = comm.axis_index(local.device).to(torch.int64)
        nv = n_valid.to(torch.int64)
        in_lanes = fingerprint_lanes(local, nl, flip=flip)
        if corrupt is not None:
            out = _apply_corrupt(out, local, nv, me, comm, corrupt, flip)
        pos = torch.arange(out.shape[-1], device=out.device)
        valid = pos < nv[..., None]
        # hash the output in the input's encoding dtype
        out_lanes = fingerprint_lanes(out.to(local.dtype), nl, mask=valid,
                                      flip=flip)
        order = ((out[..., 1:] < out[..., :-1]) & valid[..., 1:]).sum(dim=-1)
        boundary = _boundary_viol(out, nv, me, comm, grid)
        rng_viol = _range_viol(out, valid, keys, me, comm.p)
        vec = torch.cat([in_lanes, out_lanes, torch.stack(
            [nv, order, boundary, rng_viol], dim=-1)], dim=-1)
        # the psum wraps mod 2^32, as the reference's uint32 psum does
        vec = comm.psum(vec) & _M32
        return out, n_valid, keys, ranks, ovf, (stats, vec)

    return wrapped


def split_raw(raw):
    """Unwrap the `(stats, audit_vec)` stats slot of an audited launch ->
    (plain 6-tuple, audit_vec)."""
    out, counts, keys, ranks, ovf, packed = raw
    stats, vec = packed
    return (out, counts, keys, ranks, ovf, stats), vec


def audit_p1(enc: torch.Tensor, shards: torch.Tensor, counts: torch.Tensor,
             tier: str, flip: bool = False) -> torch.Tensor:
    """The audit of the driver's p == 1 short-circuit, which runs no
    shard pipeline: the same vector layout, boundary and range words zero.
    enc (B, n), shards (B, 1, n), counts (B, 1)."""
    nl = lanes_for(tier)
    rows = shards.to(enc.dtype).reshape(-1, shards.shape[-1])
    cnt = counts.to(torch.int64).reshape(-1)
    encr = enc.reshape(rows.shape[0], -1)
    valid = torch.arange(rows.shape[-1], device=rows.device) < cnt[:, None]
    in_lanes = fingerprint_lanes(encr, nl, flip=flip)
    out_lanes = fingerprint_lanes(rows, nl, mask=valid, flip=flip)
    order = ((rows[:, 1:] < rows[:, :-1]) & valid[:, 1:]).sum(dim=-1)
    zeros = torch.zeros_like(order)
    return torch.cat([in_lanes, out_lanes, torch.stack(
        [cnt, order, zeros, zeros], dim=-1)], dim=-1) & _M32


@dataclasses.dataclass
class AuditReport:
    """Host-side verdict of one audited launch (`finalize`). On the
    batched path every field is a (B,) array and `row_ok` gives per-row
    verdicts; `row(b)` views one request's verdict."""

    tier: str
    batched: bool
    n_expected: int
    count: Any
    fingerprint_ok: Any
    count_ok: Any
    order_violations: Any
    boundary_violations: Any
    range_violations: Any
    row_ok: Any
    achieved_imbalance: Any = None

    @property
    def ok(self) -> bool:
        return bool(np.all(self.row_ok))

    def row(self, b: int) -> "AuditReport":
        if not self.batched:
            return self
        pick = lambda v: None if v is None else v[b]
        return AuditReport(
            tier=self.tier, batched=False, n_expected=self.n_expected,
            count=pick(self.count), fingerprint_ok=pick(self.fingerprint_ok),
            count_ok=pick(self.count_ok),
            order_violations=pick(self.order_violations),
            boundary_violations=pick(self.boundary_violations),
            range_violations=pick(self.range_violations),
            row_ok=pick(self.row_ok),
            achieved_imbalance=pick(self.achieved_imbalance))

    def describe(self) -> str:
        if self.ok:
            return f"verify={self.tier}: ok"
        bad = np.flatnonzero(~np.atleast_1d(self.row_ok))
        parts = []
        if not np.all(self.fingerprint_ok):
            parts.append("multiset fingerprint mismatch")
        if not np.all(self.count_ok):
            lost = self.n_expected - np.atleast_1d(self.count)[bad]
            parts.append(f"count mismatch ({lost.max()} keys lost)")
        for name, v in (("sortedness", self.order_violations),
                        ("boundary", self.boundary_violations),
                        ("range", self.range_violations)):
            tot = int(np.sum(np.atleast_1d(v)))
            if tot:
                parts.append(f"{tot} {name} violations")
        where = (f"rows {bad.tolist()}" if self.batched else "output")
        return (f"verify={self.tier} FAILED on {where}: "
                + "; ".join(parts))


def finalize(audit_vec: torch.Tensor, *, tier: str, n_expected: int,
             batched: bool) -> AuditReport:
    """Copy an audit vector to the host (the one sync of an audited
    launch) and judge it. `n_expected` is the padded per-request key
    count, which the count word equals when nothing was dropped."""
    lanes = lanes_for(tier)
    with sync_site("audit.copy"):
        v = audit_vec.cpu().numpy().astype(np.uint64)
    v = v.reshape(-1, audit_width(tier))
    fp_ok = np.all(v[:, :lanes] == v[:, lanes:2 * lanes], axis=1)
    count = v[:, 2 * lanes].astype(np.int64)
    count_ok = count == n_expected
    order = v[:, 2 * lanes + 1]
    boundary = v[:, 2 * lanes + 2]
    rng_ = v[:, 2 * lanes + 3]
    row_ok = fp_ok & count_ok & (order == 0) & (boundary == 0) & (rng_ == 0)
    sq = (lambda a: a) if batched else (lambda a: a[0])
    return AuditReport(
        tier=tier, batched=batched, n_expected=int(n_expected),
        count=sq(count), fingerprint_ok=sq(fp_ok), count_ok=sq(count_ok),
        order_violations=sq(order), boundary_violations=sq(boundary),
        range_violations=sq(rng_), row_ok=sq(row_ok))
