"""Dtype and duplicate-tagging adapters (counterpart of repro.sort.adapters).

The core sorts distinct int32 or int64 keys. This module maps user keys
onto that contract and back:

  * float32 and float64 keys go through the IEEE-754 bijections onto
    int32 and int64, uint32 keys through a top-bit flip onto int32
    (repro_torch.core.tagging), int32 and int64 keys as they are;
  * duplicate keys — always for `stable=True`, `argsort` and `sort_kv`,
    auto-detected otherwise — are made distinct by implicit tagging
    (paper Section 6.3): keys are rebased to their observed range and
    packed as (key << b) | index, into int32 when key bits + tag bits
    <= 30 and into int64 when <= 62, so the tag doubles as the argsort
    permutation on the way out;
  * non-divisible inputs are padded before packing with the maximum real
    key, so pads sort to the global tail and decode trims them by index.

The port has no x64 switch: required tagging (stable, argsort, sort_kv,
tag=True, sentinel-valued keys) packs into int64 where the reference does
so under `jax.enable_x64(True)`; with x64 off the reference raises there
instead. Auto-detected duplicates are tagged only when the packing fits
int32, and sort untagged otherwise, as the reference does with x64 off:
untagged keys stay on the kernel route, where int64 packing would take
the whole sort to the torch route (kernels.dispatch: the kernels take
int32 only).

Inside the plan every key is in the encoded domain (int32 for 32-bit keys,
for uint32 the flipped one; int64 for 64-bit keys), so `key_min`/`key_max`
and the rebase are plain integer arithmetic whatever the user's dtype.

The batched engine's (B, n) requests share one plan (adapters.py:302): a
duplicate in any row tags every row, and the rebase offset and packing
budget come from the key range of all B rows, while the tag indices stay
per request. So a batched row equals `sort()` of that row alone only when
the two plans agree (fix `tag`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.common import hi_sentinel
from repro_torch.core.tagging import (
    float32_to_sortable_int32, float64_to_sortable_int64,
    sortable_int32_to_float32, sortable_int32_to_uint32,
    sortable_int64_to_float64, tag_bits, uint32_to_sortable_int32)
from repro_torch.runtime import trace
from repro_torch.runtime.syncs import move, sync_site
from repro_torch.sort.spec import SortSpec

KEY_DTYPES = (torch.int32, torch.uint32, torch.float32, torch.int64,
              torch.float64)


def to_core(x: torch.Tensor) -> torch.Tensor:
    """User keys -> order-preserving int32 (32-bit keys) or int64."""
    if x.dtype == torch.float32:
        return float32_to_sortable_int32(x)
    if x.dtype == torch.float64:
        return float64_to_sortable_int64(x)
    if x.dtype == torch.uint32:
        return uint32_to_sortable_int32(x)
    return x


def _encoded_hi(dtype: torch.dtype) -> int:
    """The encoded value of `dtype`'s +sentinel (+inf for floats)."""
    host = torch.tensor([hi_sentinel(dtype)], dtype=dtype)
    return int(to_core(host)[0])


def from_core(enc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Order-preserving int32/int64 -> user keys of `dtype`."""
    if dtype == torch.float32:
        return sortable_int32_to_float32(enc)
    if dtype == torch.float64:
        return sortable_int64_to_float64(enc)
    if dtype == torch.uint32:
        return sortable_int32_to_uint32(enc)
    return enc


class SortOutput:
    """Decoded result of `repro_torch.sort.sort`.

    shards   (p, cap) sorted keys per shard in the input dtype; slots past
             counts[i] hold the dtype's +sentinel.
    counts   (p,) valid keys per shard (pads trimmed; sums to n when
             overflow == 0).
    indices  (p, cap) original positions of the keys, -1 past counts[i];
             None when the sort ran untagged.
    overflow dropped-key count (0 => exact, the contract callers check).
    splitter_keys / splitter_ranks / stats  partitioner diagnostics
             (splitter keys decoded back to the key domain).
    recovery how the policies resolved the sort
             (repro_torch.sort.RecoveryStats); None when none recorded
             anything.
    audit    the audit's verdict (repro_torch.sort.verify.AuditReport)
             when the sort ran with verify != "off"; None otherwise.
    n        number of real input keys.
    """

    recovery = None
    audit = None
    _audit_vec = None
    _audit_expected = 0

    def __init__(self, shards, counts, indices, overflow, splitter_keys,
                 splitter_ranks, stats, n):
        self.shards = shards
        self.counts = counts
        self.indices = indices
        self.overflow = overflow
        self.splitter_keys = splitter_keys
        self.splitter_ranks = splitter_ranks
        self.stats = stats
        self.n = n

    def gather(self) -> np.ndarray:
        """All keys globally sorted, as one (n,) NumPy array."""
        from repro_torch.sort.driver import masked_concat
        return masked_concat(self.shards, self.counts)

    def gather_indices(self) -> np.ndarray:
        """The argsort permutation, as one (n,) NumPy array."""
        if self.indices is None:
            raise ValueError("sort ran untagged: no indices were tracked "
                             "(use stable=True or tag=True)")
        from repro_torch.sort.driver import masked_concat
        return masked_concat(self.indices, self.counts)


class BatchedSortOutput:
    """Decoded result of `repro_torch.sort.sort_batched`: B equal-length
    requests sorted independently in one pipeline.

    Every per-request array of SortOutput gains a leading batch axis:
    shards (B, p, cap), counts (B, p), indices (B, p, cap) | None, overflow
    (B,), splitter_keys / splitter_ranks (B, p-1), stats with per-round
    fields (k, B) and rounds_used (B,); n is the per-request key count.
    `request(b)` views one request as a SortOutput (stats stay batched);
    `recovery`, the batch's, is carried onto every view, and `audit`, the
    batch's verdict, narrowed to the request's row.
    """

    recovery = None
    audit = None
    _audit_vec = None
    _audit_expected = 0

    def __init__(self, shards, counts, indices, overflow, splitter_keys,
                 splitter_ranks, stats, n):
        self.shards = shards
        self.counts = counts
        self.indices = indices
        self.overflow = overflow
        self.splitter_keys = splitter_keys
        self.splitter_ranks = splitter_ranks
        self.stats = stats
        self.n = n

    @property
    def batch(self) -> int:
        return self.shards.shape[0]

    def request(self, b: int) -> SortOutput:
        """Request b's result as a SortOutput view."""
        out = SortOutput(
            self.shards[b], self.counts[b],
            None if self.indices is None else self.indices[b],
            self.overflow[b], self.splitter_keys[b], self.splitter_ranks[b],
            self.stats, self.n)
        out.recovery = self.recovery
        if self.audit is not None:
            out.audit = self.audit.row(b)
        return out

    def gather(self, b: int) -> np.ndarray:
        """Request b's keys, globally sorted, as one (n,) NumPy array."""
        return self.request(b).gather()

    def gather_indices(self, b: int) -> np.ndarray:
        """Request b's argsort permutation as one (n,) NumPy array."""
        return self.request(b).gather_indices()

    def gather_all(self) -> list:
        """Every request gathered, in batch order."""
        return [self.gather(b) for b in range(self.batch)]


@dataclasses.dataclass
class AdapterPlan:
    n: int                 # real keys (per request on the batched path)
    n_pad: int
    out_dtype: torch.dtype  # user-facing key dtype
    tagged: bool = False
    tag_b: int = 0
    key_min: int = 0       # rebase offset in the encoded domain
    key_max: int = 0
    pack_dtype: torch.dtype = torch.int32   # the tagged keys' dtype
    _enc: torch.Tensor | None = None   # encoded keys, cached by make_plan

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Keys (n,), or (B, n) for the batched engine -> the distinct
        int32/int64 core domain; every row gets its own index tags."""
        enc = self._enc if self._enc is not None else to_core(x)
        if not self.tagged:
            return enc       # pads (hi sentinel) are appended by the driver
        if self.n_pad:       # pads = max real key; they sort to the tail
            pad = torch.full(enc.shape[:-1] + (self.n_pad,), self.key_max,
                             dtype=enc.dtype, device=enc.device)
            enc = torch.cat([enc, pad], dim=-1)
        # the rebased key fits the pack dtype (make_plan checked the bits)
        e = (enc.to(torch.int64) - self.key_min).to(self.pack_dtype)
        idx = torch.arange(e.shape[-1], dtype=self.pack_dtype,
                           device=e.device)
        return (e << self.tag_b) | idx

    @property
    def flipped_words(self) -> bool:
        """Untagged uint32 keys: the encoded words are the reference's
        uint32 words with the top bit flipped (what the audit undoes)."""
        return self.out_dtype == torch.uint32 and not self.tagged

    def encode_probes(self, probes) -> torch.Tensor:
        """Warm-start probes (key domain) -> encoded domain."""
        probes = to_core(as_keys(probes, self._enc.device))
        if not self.tagged:
            return probes
        return ((probes.to(torch.int64) - self.key_min) << self.tag_b
                ).to(self.pack_dtype)

    def decode_batched(self, raw) -> BatchedSortOutput:
        """The raw batched driver tuple (shards (B, p, cap), counts (B, p),
        ...) -> BatchedSortOutput."""
        shards, counts, skeys, sranks, overflow, stats = raw
        cap = shards.shape[-1]
        pos = torch.arange(cap, dtype=torch.int32, device=shards.device)
        valid = pos < counts[..., None]
        indices = None
        if self.tagged:
            raw_idx = shards & ((1 << self.tag_b) - 1)
            if self.n_pad:
                # pads carry indices >= n; they may have been counted as
                # valid by the exchange — exact even under key drops
                pads = valid & (raw_idx >= self.n)
                counts = counts - pads.sum(dim=-1, dtype=torch.int32)
                valid = pos < counts[..., None]
            indices = torch.where(valid, raw_idx, -1)
            shards = self._unrebase(shards >> self.tag_b)
            if skeys.numel():
                skeys = self._unrebase(skeys >> self.tag_b)
        # fill past the counts with the user dtype's +sentinel, written in
        # the encoded domain (torch's uint32 kernels are few)
        shards = torch.where(valid, shards, _encoded_hi(self.out_dtype))
        # p == 1's empty splitter keys keep the reference's encoded dtype:
        # the pack dtype when tagged, int32/int64 for float keys, the key
        # dtype otherwise
        if skeys.numel() or (self.out_dtype == torch.uint32
                             and not self.tagged):
            skeys = from_core(skeys, self.out_dtype)
        return BatchedSortOutput(
            from_core(shards, self.out_dtype), counts, indices, overflow,
            skeys, sranks, stats, self.n)

    def _unrebase(self, rebased: torch.Tensor) -> torch.Tensor:
        """Rebased pack dtype -> the encoded domain, wrapping mod 2^32 (or
        2^64) as the reference's fixed-width arithmetic does (only
        sentinel slots and sentinel splitter keys ever wrap)."""
        wide = rebased.to(torch.int64) + self.key_min
        if self._enc.dtype == torch.int64:
            return wide
        return ((wide + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def as_keys(x, device) -> torch.Tensor:
    """NumPy array, tensor or sequence -> contiguous 1-D tensor on device."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    # an upload from pageable memory is queued, not waited for
    return move(x, device).contiguous()


def _needs_tags(x: torch.Tensor, spec: SortSpec, want_indices: bool):
    """-> (wanted, required, duplicated). Required tagging errors out when
    the packing budget does not fit; merely wanted tagging (auto duplicate
    detection) falls back to untagged, which still sorts correctly.
    `want_indices` (argsort, sort_kv) always tags. `duplicated` is None,
    or under auto detection a device flag that decides `wanted` once the
    plan reads it on the host."""
    if spec.tag is not None:
        if not spec.tag and want_indices:
            raise ValueError("argsort/sort_kv require tagging (tag=False set)")
        return spec.tag, spec.tag, None
    if spec.stable or want_indices:
        return True, True, None
    # auto duplicate detection, as the reference does it with a plain
    # jnp.sort outside any kernel: sort each row, compare neighbours (float
    # keys compare as floats, so -0.0 == 0.0). On a (B, n) batch any
    # duplicated row tags the whole batch.
    s = torch.sort(x.view(torch.int32) if x.dtype == torch.uint32 else x,
                   dim=-1).values
    return False, False, (s[..., 1:] == s[..., :-1]).any()


def make_plan(x: torch.Tensor, spec: SortSpec, p: int,
              want_indices: bool = False) -> AdapterPlan:
    """Inspect the input, (n,) or a (B, n) batch, and decide bijection,
    tagging and padding: one plan for the whole batch, its key range taken
    over all B rows."""
    n = x.shape[-1]
    if n == 0 or x.numel() == 0:
        raise ValueError("cannot sort an empty array")
    if x.dtype not in KEY_DTYPES:
        raise ValueError(
            f"unsupported key dtype {x.dtype}: the port sorts int32, "
            "uint32, float32, int64 and float64 keys")
    n_pad = (-n) % p
    plan = AdapterPlan(n=n, n_pad=n_pad, out_dtype=x.dtype)
    with trace.span("plan"):
        enc = to_core(x)
        plan._enc = enc

        wanted, required, duplicated = _needs_tags(x, spec, want_indices)
        # the key range and the duplicate flag reach the host in one copy
        probe = [enc.max(), enc.min()]
        if duplicated is not None:
            probe.append(duplicated)
        with sync_site("plan.probe"):
            probe = torch.stack([v.to(torch.int64) for v in probe]).tolist()
    key_max, key_min = probe[:2]
    if duplicated is not None:
        wanted = bool(probe[2])
    if key_max == torch.iinfo(enc.dtype).max:
        # keys whose encoded value equals the hi sentinel of the untagged
        # path (dtype max, or a float NaN payload mapping onto it) would be
        # dropped as padding; tagging rebases them below it
        if spec.tag is False:
            raise ValueError(
                f"keys contain the {x.dtype} sentinel value (dtype max, or a "
                "NaN payload mapping onto it) reserved by the untagged path "
                "(tag=False): remove those keys or drop tag=False")
        wanted = required = True
    if not wanted:
        return plan

    key_bits = max(1, (key_max - key_min).bit_length())
    b = tag_bits(p, (n + n_pad) // p)
    total = key_bits + b
    # one bit of headroom below each pack dtype's sentinel
    if total <= 30:
        pack_dtype = torch.int32
    elif not required:
        return plan           # auto-tagging does not fit int32: untagged
    elif total <= 62:
        pack_dtype = torch.int64
    else:
        raise ValueError(f"key_bits={key_bits} + tag_bits={b} > 62: "
                         "compress the key range before sorting")
    plan.tagged = True
    plan.tag_b = b
    plan.key_min = key_min
    plan.key_max = key_max
    plan.pack_dtype = pack_dtype
    return plan
