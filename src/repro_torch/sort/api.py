"""The sort front door: `sort`, `sort_batched`, `argsort`, `sort_kv` and
`gather` (counterpart of repro.sort.api).

    from repro_torch.sort import SortSpec, argsort, sort, sort_batched
    out = sort(x)                                 # HSS, 8 shards, on the card
    out = sort(x, SortSpec(shards=4, device="cpu"))
    out = sort(x, algorithm="ams")                # or sample_random,
                                                  # sample_regular, multistage
    out = sort(x, exchange="ragged")              # the exact alltoallv
    out = sort(x, kernel_policy="torch")          # kwargs override the spec
    out.gather()                                  # flat sorted NumPy array
    out = sort(x, on_overflow="retry")            # exact; see out.recovery

    outs = sort_batched(xs)                       # xs (B, n): one pipeline
    outs.gather(b)                                # request b, sorted
    views = sort_batched([x0, x1, x2])            # any lengths: one batch
                                                  # per length, input order
    outs = sort(xs, SortSpec(batch=True))         # the same as sort_batched

    order = argsort(x)                            # stable, NumPy (n,)
    keys, vals = sort_kv(expert_ids, token_ids)   # from repro_torch.sort

`x` is a 1-D int32, uint32, float32, int64 or float64 NumPy array or
tensor. The overflow policy (`SortSpec.on_overflow`) runs around every
launch: under "raise" `out.overflow` is returned on the device, uncounted
on the host, and 0 means the result is exact (as at repro/sort/api.py:294);
"retry" reads it on the host once per launch and escalates; "spill" swaps
in the exact dense_spill exchange. `argsort` and `sort_kv` raise when the
gathered permutation is short, whatever the policy.

Around the overflow policy run the verification policy and then the
imbalance SLO (`_with_policies`, as repro/sort/api.py:473-482):

    out = sort(x, verify="cheap")                 # out.audit: AuditReport
    out = sort(x, verify="full", on_verify_failure="retry")
    out = sort(x, verify="cheap", imbalance_slo=1.2)
    out.recovery.achieved_imbalance               # max load / (N/p)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ams import ams_sample_size
from repro_torch.core.sample_sort import (
    default_regular_s, default_total_sample)
from repro_torch.kernels import dispatch
from repro_torch.runtime import chaos
from repro_torch.runtime.syncs import sync_site
from repro_torch.sort import driver, verify
from repro_torch.sort.adapters import (
    BatchedSortOutput, SortOutput, as_keys, make_plan)
from repro_torch.sort.grouping import group_by_length
from repro_torch.sort.partitioners import ShardCtx, get_partitioner
from repro_torch.sort.spec import SortSpec
from repro_torch.sort.verify import (
    BatchVerificationError, ImbalanceError, VerificationError)


@dataclasses.dataclass(frozen=True)
class RecoveryStats:
    """How the recovery policies resolved a sort (`out.recovery`; None when
    no policy recorded anything). Field for field the reference's
    (repro/sort/api.py:38-73).

    policy            the on_overflow policy that ran.
    attempts          launches in all; 1 = the first was already exact.
    escalations       capacity_scale of each re-launch, in order.
    spill_fallback    True when the last attempt ran on the spill channel.
    recovered_overflow  the first (failed) launch's overflow count.
    verify_failures   audits that failed, over all launches.
    verify_retries    re-launches the on_verify_failure="retry" policy
                      spent.
    verify_fallback   True when a failed audit was re-run on the fallback
                      path (spill channel, kernel_policy="torch").
    achieved_imbalance  max shard load / (N/p) of the served output (the
                      worst row on the batched path); recorded when verify
                      is on or an imbalance_slo is set.
    imbalance_recovery  None, or the rung that met the SLO: "tag" or
                      "refine".
    """

    policy: str
    attempts: int
    escalations: tuple
    spill_fallback: bool
    recovered_overflow: int
    verify_failures: int = 0
    verify_retries: int = 0
    verify_fallback: bool = False
    achieved_imbalance: float | None = None
    imbalance_recovery: str | None = None


def _as_spec(spec, overrides) -> SortSpec:
    if spec is None:
        return SortSpec(**overrides)
    if not isinstance(spec, SortSpec):
        raise TypeError(f"spec must be a SortSpec, got {type(spec)}")
    return dataclasses.replace(spec, **overrides) if overrides else spec


def _mesh_fingerprint(spec: SortSpec):
    """The structural identity of the emulated mesh: the shard count, the
    multistage grid and the device (the reference's mesh shape and device
    ids, api.py:85-91)."""
    return (spec.shards, spec.stages, torch.device(spec.device))


def _spec_trace_fields(spec: SortSpec) -> tuple:
    """The SortSpec fields that shape the shard program (the seed is a
    per-call argument, the keys' shape and dtype come with the encoded
    array), as the reference's (api.py:94-110). The chaos trace token
    rides along: a plan that clamps the exchange's capacities is keyed
    apart, so a clamped launch never counts as a hit of the unclamped
    line (repro_torch.runtime.chaos)."""
    return (spec.algorithm, spec.eps, spec.rounds, spec.sample_per_shard,
            spec.adaptive, spec.total_sample, spec.s,
            spec.resolved_exchange(), spec.pair_factor, spec.out_slack,
            spec.capacity_scale, spec.kernel_policy, spec.verify,
            spec.semisort_sample, spec.heavy_fraction,
            chaos.trace_token())


def spec_fingerprint(spec: SortSpec):
    """Hashable fingerprint of every SortSpec field that decides a
    request's served bits: the program-shaping fields, the semantic ones
    (stable and tag change the adapter plan, the seed the sampled
    splitters) and the mesh (api.py:113-124). None when the spec carries
    state no fingerprint captures (warm-start probes): such a spec shares
    no cache key and no serving batch."""
    if spec.initial_probes is not None:
        return None
    return _spec_trace_fields(spec) + (
        spec.stable, spec.tag, spec.seed, spec.on_verify_failure,
        spec.imbalance_slo, _mesh_fingerprint(spec))


def _dtype_name(dtype) -> str:
    """NumPy's name of a key dtype ("int32", "float32", ...), for a NumPy
    or a torch dtype alike."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def bucket_key(n, dtype, spec: SortSpec, *, kind: str = "sort", param=None):
    """The serving batch's grouping key (repro_torch.serve): requests that
    share it stack into one `sort_batched` launch (same length, key dtype,
    request kind and spec fingerprint) and so share one cache key per
    batch size (api.py:127-148). Opaque specs (warm-start
    probes) bucket by identity: they never share a batch. `param` is a
    kind's launch-shaping scalar (top_k's k); None leaves the key as the
    other kinds have it."""
    fp = spec_fingerprint(spec)
    if fp is None:
        fp = ("opaque", id(spec))
    key = (kind, int(n), _dtype_name(dtype), fp)
    return key if param is None else key + (param,)


def _cache_key(spec: SortSpec, enc: torch.Tensor, *, flip: bool = False):
    """The cache key of a launch (api.py:151-159): the spec's program
    fields, the mesh, and the encoded batch's shape and dtype (an
    unbatched sort is the batched engine at B = 1, so it shares the
    batched line of its (1, n) shape). `flip` is the audit's uint32 word
    flip, which the encoded dtype (int32) does not show. None (uncached)
    when the spec carries warm-start probes, which the reference's program
    would capture."""
    if spec.initial_probes is not None:
        return None
    return (("batched",) + _spec_trace_fields(spec)
            + (_mesh_fingerprint(spec), tuple(enc.shape), str(enc.dtype),
               flip))


def resolve_device(device) -> torch.device:
    """The spec's device; a CUDA device with no card raises (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SortSpec(device='cuda') but no CUDA device is available; pass "
            "device='cpu' to run the port's plain versions on the CPU")
    return dev


def sort(x, spec: SortSpec | None = None, *, uniform=None,
         **overrides) -> SortOutput:
    """Sort a 1-D key array over `spec.shards` emulated shards, under the
    spec's overflow policy. With `SortSpec(batch=True)` the input goes to
    `sort_batched` instead.

    `uniform` (optional) injects the sampling draws: (j, n) -> (p, n)
    float32 U[0, 1) array, draw j of n keys a shard, row s for shard s, in
    place of the seeded generator (the parity tests feed the reference's
    draws; `repro_torch.sort.partitioners` says how each algorithm
    numbers its draws). Every attempt of the retry policy takes the same
    draws, as every attempt of the reference's reseeds from
    `spec.seed`."""
    spec = _as_spec(spec, overrides)
    if spec.batch:
        return sort_batched(x, spec, uniform=uniform)
    x = as_keys(x, resolve_device(spec.device))
    return _with_policies(
        lambda s: _sort_one(x, s, uniform, want_indices=False), spec)


def _sort_one(x, spec: SortSpec, uniform, want_indices: bool) -> SortOutput:
    """One launch of one request, x a tensor on the spec's device: the
    batched engine at B = 1, the batch axis squeezed out."""
    if x.dim() != 1:
        raise ValueError(f"sort expects a 1-D key array, got {tuple(x.shape)}")
    if spec.initial_probes is not None:
        spec = dataclasses.replace(
            spec, initial_probes=as_keys(spec.initial_probes, x.device)[None])
    batch = _sort_batched_impl(x[None], spec, uniform, want_indices)
    out = batch.request(0)
    out._audit_vec = batch._audit_vec
    out._audit_expected = batch._audit_expected
    if out.stats is not None:
        out.stats = type(out.stats)(*(f[..., 0] for f in out.stats))
    return out


def sort_batched(xs, spec: SortSpec | None = None, *, uniform=None,
                 **overrides):
    """Sort B independent key arrays in one pipeline, under the spec's
    overflow policy (one policy for the batch: "retry" re-runs the whole
    batch while any request overflows).

    xs: a (B, n) array of B equal-length requests — returns a
    BatchedSortOutput — or a list or tuple of 1-D arrays of any lengths,
    which is bucketed by length (`group_by_length`; one batch per distinct
    length, each under the policy) and returns a list of per-request
    SortOutput views in input order. Per request the result is
    bit-identical to `sort()` of that request with the same spec and seed
    when both plans agree (fix `tag`); each collective of the batch-fused
    exchanges is one call per phase whatever B is. `uniform` is as in
    `sort`: every request shares the shards' draws.
    """
    spec = _as_spec(spec, overrides)
    if isinstance(xs, (list, tuple)):
        return _sort_batched_buckets(xs, spec, uniform)
    xs = as_keys(xs, resolve_device(spec.device))
    return _with_policies(
        lambda s: _sort_batched_impl(xs, s, uniform), spec, batched=True)


def _sort_batched_impl(xs, spec: SortSpec, uniform,
                       want_indices: bool = False) -> BatchedSortOutput:
    part = get_partitioner(spec.algorithm)
    dev = resolve_device(spec.device)
    xs = as_keys(xs, dev)
    if xs.dim() != 2:
        raise ValueError(
            f"sort_batched expects a (B, n) key array, got {tuple(xs.shape)}")
    p = spec.shards

    plan = make_plan(xs, spec, p, want_indices=want_indices)
    enc = plan.encode(xs)
    probes = (plan.encode_probes(spec.initial_probes)
              if spec.initial_probes is not None else None)

    cache_key = _cache_key(spec, enc, flip=plan.flipped_words)
    audit = spec.verify != "off" and p > 1
    corrupt = chaos.corrupt_now() if audit else None
    if corrupt is not None:
        cache_key = None   # a corrupted launch is never counted as cached

    def build():
        def sort_fn(rows, comm, draws):
            ctx = ShardCtx(spec=spec, comm=comm, uniform=draws,
                           initial_probes=probes)
            return part.sharded_batched(rows, ctx)

        if not audit:
            return sort_fn
        return verify.audited(
            sort_fn, tier=spec.verify, grid=spec.algorithm == "multistage",
            corrupt=corrupt, flip=plan.flipped_words)

    raw = driver.run_batched(
        driver.shard_program(cache_key, build, p), enc, p=p, seed=spec.seed,
        n_real=plan.n,
        local_sort_fn=dispatch.local_sort_fn(spec.kernel_policy),
        uniform=uniform)
    audit_vec = None
    if audit:
        raw, audit_vec = verify.split_raw(raw)
    elif spec.verify != "off":   # p == 1 runs no shard pipeline
        audit_vec = verify.audit_p1(enc, raw[0], raw[1], spec.verify,
                                    flip=plan.flipped_words)
    out = plan.decode_batched(raw)
    out._audit_vec = audit_vec
    out._audit_expected = plan.n + plan.n_pad
    return out


def _sort_batched_buckets(arrs, spec: SortSpec, uniform) -> list:
    """List input: one batch per distinct length, results back in input
    order as SortOutput views."""
    dev = resolve_device(spec.device)
    arrs = [as_keys(a, dev) for a in arrs]
    for a in arrs:
        if a.dim() != 1:
            raise ValueError(f"sort_batched list entries must be 1-D, got "
                             f"{tuple(a.shape)}")
    results = [None] * len(arrs)
    for idxs in group_by_length(arrs).values():
        stacked = torch.stack([arrs[i] for i in idxs])
        out = _with_policies(
            lambda s, xs=stacked: _sort_batched_impl(xs, s, uniform), spec,
            batched=True)
        for j, i in enumerate(idxs):
            results[i] = out.request(j)
    return results


def _host_overflow(out) -> int:
    """The overflow counter on the host: the retry policy's one deliberate
    host sync per launch (the max over the batch on the batched path)."""
    with sync_site("retry.overflow"):
        return int(out.overflow.max())


def _warm_started(spec: SortSpec, out) -> SortSpec:
    """A failed attempt's splitter keys as warm-start probes, so the retry
    ranks p-1 known-good keys before it samples (the ChaNGa trick,
    pointed at recovery). HSS only: it is the one partitioner that takes
    probes (repro/sort/api.py:273)."""
    if spec.algorithm != "hss":
        return spec
    sk = out.splitter_keys
    if sk is None or sk.numel() == 0:
        return spec
    return dataclasses.replace(spec, initial_probes=sk)


def _with_overflow_policy(run, spec: SortSpec):
    """`run(spec)` under the spec's overflow policy (counterpart of
    repro/sort/api.py:261-304).

    "raise" and "spill" read no counter here: spill swapped the exchange
    for the exact channel in `spec.exchange_config()`, and raise leaves
    the check to the caller (`argsort`/`sort_kv` check the gathered
    length). "retry" reads the counter once per launch and, while it is
    nonzero, runs again with `capacity_scale` doubled and the failed
    attempt's splitters as warm start; the last attempt runs on the spill
    channel, and a RuntimeError follows only if even that truncates."""
    out = run(spec)
    if spec.on_overflow != "retry":
        return out
    ovf0 = _host_overflow(out)
    if ovf0 == 0:
        out.recovery = RecoveryStats("retry", 1, (), False, 0)
        return out
    esc = []
    for k in range(1, spec.max_overflow_retries + 1):
        scale = spec.capacity_scale * (2.0 ** k)
        esc.append(scale)
        out = run(dataclasses.replace(_warm_started(spec, out),
                                      capacity_scale=scale))
        if _host_overflow(out) == 0:
            out.recovery = RecoveryStats("retry", 1 + len(esc), tuple(esc),
                                         False, ovf0)
            return out
    out = run(dataclasses.replace(
        _warm_started(spec, out), on_overflow="spill",
        capacity_scale=esc[-1] if esc else spec.capacity_scale))
    left = _host_overflow(out)
    out.recovery = RecoveryStats("retry", 2 + len(esc), tuple(esc), True,
                                 ovf0)
    if left != 0:
        raise RuntimeError(
            f"sort overflow unrecovered after {len(esc)} capacity "
            f"escalations and a spill-channel attempt ({left} keys "
            "truncated at out_cap): the splitting violated its eps "
            "guarantee; raise out_slack or eps")
    return out


def _update_recovery(out, spec: SortSpec, **fields) -> None:
    """Merge verify and imbalance results into the output's RecoveryStats,
    making a baseline record when no overflow policy attached one."""
    base = out.recovery
    if base is None:
        base = RecoveryStats(spec.on_overflow, 1, (), False, 0)
    out.recovery = dataclasses.replace(base, **fields)


def _finalize_audit(out, spec: SortSpec):
    """Copy a launch's audit vector to the host and judge it (the one
    sync of an audited launch); attach it as `out.audit`. None when the
    launch ran unaudited."""
    vec = getattr(out, "_audit_vec", None)
    if vec is None:
        return None
    report = verify.finalize(
        vec, tier=spec.verify, n_expected=out._audit_expected,
        batched=isinstance(out, BatchedSortOutput))
    report.achieved_imbalance = _imbalance(out)
    out.audit = report
    return report


def _imbalance(out):
    """achieved_imbalance = max shard load / (N/p), per request on the
    batched path ((B,) array). The loads are copied once an output and
    kept on it."""
    counts = getattr(out, "_host_counts", None)
    if counts is None:
        with sync_site("imbalance"):
            counts = out.counts.cpu().numpy()
        out._host_counts = counts
    p = counts.shape[-1]
    return counts.max(axis=-1).astype(np.float64) * p / float(out.n)


def _fallback_spec(spec: SortSpec) -> SortSpec:
    """The configuration a failed audit falls back to: the exact spill
    channel and the torch primitives (the reference's "xla" policy), which
    sidesteps both the dropping exchange and a suspect kernel."""
    return dataclasses.replace(spec, on_overflow="spill",
                               kernel_policy="torch")


def _enforce_verify(inner, spec: SortSpec, out, *, batched: bool):
    """Apply `spec.on_verify_failure` to an audited output: on a failed
    audit, "retry" re-runs once, then falls back, then raises; "fallback"
    falls back, then raises; "raise" raises. Every attempt is audited and
    the trail lands on `out.recovery`."""
    report = _finalize_audit(out, spec)
    if report is None:
        return out
    failures = retries = 0
    fellback = False
    while not report.ok:
        failures += 1
        if spec.on_verify_failure == "retry" and retries == 0:
            retries = 1
            cand = inner(spec)
        elif spec.on_verify_failure in ("retry", "fallback") \
                and not fellback:
            fellback = True
            cand = inner(_fallback_spec(spec))
        else:
            _update_recovery(out, spec, verify_failures=failures,
                             verify_retries=retries,
                             verify_fallback=fellback,
                             achieved_imbalance=float(
                                 np.max(report.achieved_imbalance)))
            msg = report.describe()
            if batched:
                raise BatchVerificationError(msg, report, out)
            raise VerificationError(msg, report)
        report = _finalize_audit(cand, spec)
        out = cand
    _update_recovery(out, spec, verify_failures=failures,
                     verify_retries=retries, verify_fallback=fellback,
                     achieved_imbalance=float(
                         np.max(report.achieved_imbalance)))
    return out


def _refined_spec(spec: SortSpec, p: int, n_local: int) -> SortSpec:
    """The SLO ladder's bonus refinement: twice the sampling of whichever
    knob the algorithm samples with, and two more histogram rounds for the
    HSS family."""
    if spec.algorithm in ("hss", "multistage"):
        cfg = spec.hss_config()
        return dataclasses.replace(
            spec, rounds=cfg.resolved_rounds(p) + 2,
            sample_per_shard=2 * cfg.resolved_sample_cap(p))
    if spec.algorithm == "sample_regular":
        return dataclasses.replace(
            spec, s=2 * (spec.s or default_regular_s(p, spec.eps)))
    if spec.algorithm == "ams":
        base = spec.total_sample or ams_sample_size(p, spec.eps, n_local * p)
        return dataclasses.replace(spec, total_sample=2 * base)
    base = spec.total_sample or default_total_sample(p, n_local, spec.eps)
    return dataclasses.replace(spec, total_sample=2 * base)


def _enforce_slo(inner, spec: SortSpec, out, *, batched: bool):
    """The partition-quality SLO (DESIGN.md Sec. 9.2): record
    achieved_imbalance when verify is on or an SLO is set and, when it is
    over `spec.imbalance_slo`, re-run with duplicate tagging, then with
    bonus refinement, raising ImbalanceError only when both miss."""
    slo = spec.imbalance_slo
    if slo is None and spec.verify == "off":
        return out
    worst = float(np.max(_imbalance(out)))
    recovery = None
    if slo is not None and worst > slo:
        p = out.counts.shape[-1]
        n_local = (out.n + (-out.n) % p) // p
        ladder = []
        untagged = out.indices is None and spec.tag is None
        if untagged:
            ladder.append(("tag", dataclasses.replace(spec, tag=True)))
        refine_base = dataclasses.replace(spec, tag=True) if untagged else spec
        ladder.append(("refine", _refined_spec(refine_base, p, n_local)))
        for name, cand_spec in ladder:
            try:
                cand = inner(cand_spec)
            except ValueError:   # the tag packing does not fit
                continue
            rep = _finalize_audit(cand, cand_spec)
            if rep is not None and not rep.ok:
                raise VerificationError(
                    "imbalance-SLO recovery attempt failed its own audit: "
                    + rep.describe(), rep)
            ci = float(np.max(_imbalance(cand)))
            if ci <= slo:
                out, worst, recovery = cand, ci, name
                break
        else:
            _update_recovery(out, spec, achieved_imbalance=worst)
            raise ImbalanceError(
                f"achieved_imbalance {worst:.3f} > imbalance_slo {slo:.3f} "
                f"after duplicate tagging and bonus refinement "
                f"(algorithm={spec.algorithm}, eps={spec.eps})", worst, slo)
    if getattr(out, "audit", None) is not None:
        out.audit.achieved_imbalance = _imbalance(out)
    _update_recovery(out, spec, achieved_imbalance=worst,
                     imbalance_recovery=recovery)
    return out


def _with_policies(run, spec: SortSpec, *, batched: bool = False):
    """The policy stack around one sort: the overflow policy innermost
    (every launch, verify and SLO re-launches too, gets overflow
    recovery), then the verification policy, then the imbalance SLO."""
    inner = lambda s: _with_overflow_policy(run, s)
    out = inner(spec)
    out = _enforce_verify(inner, spec, out, batched=batched)
    return _enforce_slo(inner, spec, out, batched=batched)


def gather_perm_checked(out: SortOutput, what: str) -> np.ndarray:
    """The permutation of a tagged sort, checked for exactness: dropped
    keys are exactly the keys missing from the gather, so the gathered
    length is checked, not the overflow counter (which also counts
    harmless sample-buffer overflow and dropped pads)."""
    order = out.gather_indices()
    if order.shape[0] != out.n:
        raise RuntimeError(
            f"{what}: exchange dropped {out.n - order.shape[0]} keys "
            "(capacity overflow): the result would not be a permutation. "
            "Use on_overflow='retry'/'spill', raise pair_factor/out_slack, "
            "or use exchange='allgather'.")
    return order


def argsort(x, spec: SortSpec | None = None, *, uniform=None,
            **overrides) -> np.ndarray:
    """Stable argsort: the permutation that sorts x, as a flat (n,) NumPy
    array. The tag of each key is its index, so the permutation comes out
    of the sorted keys. Raises if the exchange dropped keys;
    on_overflow="retry"/"spill" recover instead. `uniform` is as in
    `sort`."""
    spec = dataclasses.replace(_as_spec(spec, overrides), stable=True)
    x = as_keys(x, resolve_device(spec.device))
    out = _with_policies(
        lambda s: _sort_one(x, s, uniform, want_indices=True), spec)
    return gather_perm_checked(out, "argsort")


def sort_kv(keys, values, spec: SortSpec | None = None, *, uniform=None,
            **overrides):
    """Sort (key, value) pairs by key, stably -> NumPy (sorted_keys,
    sorted_values). Values may be multi-dimensional: the permutation
    applies along their leading axis, which must match the keys."""
    values = np.asarray(values)
    if values.shape[:1] != tuple(np.shape(keys)):
        raise ValueError(f"values leading dim {values.shape[:1]} != "
                         f"keys shape {tuple(np.shape(keys))}")
    spec = dataclasses.replace(_as_spec(spec, overrides), stable=True)
    keys = as_keys(keys, resolve_device(spec.device))
    out = _with_policies(
        lambda s: _sort_one(keys, s, uniform, want_indices=True), spec)
    order = gather_perm_checked(out, "sort_kv")
    return out.gather(), values[order]


def gather(out: SortOutput) -> np.ndarray:
    """Module-level alias for SortOutput.gather()."""
    return out.gather()
