"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The reference (`repro`, JAX) and the port (`repro_torch`) run in one
process on the CPU and exchange only NumPy arrays:

  * `auto_mesh(p)`: the reference's 1-D sort mesh with an Auto axis (the
    default Explicit axes of jax.make_mesh break the reference's gather,
    ROADMAP queue 3 item 1);
  * `reference_uniform(seed, p, n_local, k)`: the reference's own HSS
    draws — jr.fold_in(jr.key(seed), shard) (sort/driver.py:292), one
    jr.split per round (core/splitters.py:217), jr.uniform(sub, (n_local,))
    (:164) — as a (j, n) -> (p, n) float32 source the port takes;
    `reference_draws(ref_spec, p, n)` gives each algorithm's: HSS's (of
    any round the port asks for, so the SLO ladder's extra rounds too);
    sample_random's and ams's one unsplit jr.uniform of the shard key
    (sample_sort.py:42, ams.py:66); multistage's split of the key into
    two stage keys, each split once a round (multistage.py:92, :57);
  * `auto_mesh2d(r1, r2)`: multistage's (outer, inner) Auto mesh;
  * `port_spec(ref_spec, p)`: a reference SortSpec mapped field by field
    onto the port's, on the CPU (a 2-D mesh's shape as `stages`);
  * `sort_batched_both(xs, p, ...)`, `sort_both`, `argsort_both` and
    `sort_kv_both`: the reference's and the port's front door on the same
    keys, the reference's draws injected; `x64=True` runs the reference
    under `jax.enable_x64(True)`, where it packs into int64 and takes
    float64 and int64 keys, as the port always does (every attempt of a
    retry takes the same draws in both packages, so one stream serves);
  * `semisort_both`, `semisort_batched_both`, `top_k_both`,
    `top_k_batched_both` and `groupby_both`: the grouping front doors
    (the reference's `repro.sort.semisort` functions called directly);
    `chaotic(fn, chaos, plan)` runs a front door under a FaultPlan of
    either package's chaos module;
  * `model_ctx(tp, shard_heads)`: the model stack's reference
    ParallelCtx over an Auto (1, tp) ("data", "model") mesh (the default
    `repro.parallel.local_ctx()` builds Explicit axes, which the
    reference's sharding constraints refuse) beside the port's
    ParallelCtx(tp_size=tp); `model_both(arch, seed, **changes)`: a
    smoke config in float32 on both sides (`dataclasses.replace`), the
    reference's `init_params` and its tree carried into the port with
    `params_from_reference`; `assert_tree_close` compares two trees of
    arrays leaf by leaf;
  * `assert_bits_equal` / `assert_sort_outputs_equal` /
    `assert_batched_outputs_equal` / `assert_recovery_equal` /
    `assert_audit_equal` / `assert_semisort_equal`:
    zero-tolerance comparisons (float arrays are compared as their bit
    patterns). Under x64 the reference widens its counters (overflow,
    gamma_size, n_satisfied, rounds_used) to int64; with `x64=True` the
    counters are compared by value, the keys and indices still by dtype
    and bits.
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.random as jr
import numpy as np
import torch
from jax.sharding import AxisType

import repro.configs as rconfigs
import repro.models.params as rparams
import repro.sort as rsort
import repro_torch.configs as tconfigs
import repro_torch.models.params as tparams
import repro.sort.driver as rdriver
import repro_torch.sort as tsort
from repro.core.common import HSSConfig
from repro.core.exchange import ExchangeConfig
from repro.sort import SortSpec as RefSortSpec
from repro_torch.core.common import HSSConfig as TorchHSSConfig
from repro_torch.core.exchange import ExchangeConfig as TorchExchangeConfig
from repro.parallel.ctx import ParallelCtx as RefParallelCtx
from repro_torch.parallel.ctx import ParallelCtx


def auto_mesh(p: int):
    return jax.make_mesh((p,), ("sort",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:p])


def auto_mesh2d(r1: int, r2: int):
    return jax.make_mesh((r1, r2), ("outer", "inner"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:r1 * r2])


def model_ctx(tp: int = 1, shard_heads: bool = True):
    """(port ctx, reference ctx) of one (dp=1, tp) layout; the reference's
    over an Auto-axes ("data", "model") mesh of 1 x tp host devices."""
    mesh = jax.make_mesh((1, tp), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:tp])
    ref = RefParallelCtx(mesh=mesh, dp_axes=("data",), tp_axis="model",
                         shard_heads=shard_heads)
    return ParallelCtx(tp_size=tp, shard_heads=shard_heads), ref


def model_both(arch: str, seed: int = 0, **changes):
    """(port cfg, reference cfg, port params, reference params): the
    smoke config of `arch` in float32 with `changes`, the reference's
    init_params(jr.key(seed)) and its carried copy on the CPU."""
    changes.setdefault("dtype", "float32")
    ref_cfg = dataclasses.replace(rconfigs.smoke_config(arch), **changes)
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), **changes)
    ref_params = rparams.init_params(ref_cfg, jr.key(seed))
    params = tparams.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu")
    return cfg, ref_cfg, params, ref_params


def assert_tree_close(got, want, rtol: float, atol: float, what: str = ""):
    """Two trees of arrays (dicts and tuples), leaf by leaf: same
    structure, shapes and dtypes, values within the tolerance."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            what, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], rtol, atol, f"{what}/{k}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, rtol, atol, f"{what}[{i}]")
        return
    g, w = to_numpy(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def reference_uniform(seed: int, p: int, n_local: int, k: int):
    """(j, n) -> (p, n_local) float32: the reference's per-shard HSS
    draws of round j < k."""
    return _round_draws([jr.fold_in(jr.key(seed), s) for s in range(p)],
                        n_local, k)


def _round_draws(keys, n_local: int, k: int):
    """One jr.split of each shard key a round, jr.uniform of the subkey."""
    keys = list(keys)
    rounds = []
    for _ in range(k):
        row = []
        for s in range(len(keys)):
            keys[s], sub = jr.split(keys[s])
            row.append(np.asarray(jr.uniform(sub, (n_local,))))
        rounds.append(np.stack(row))
    return lambda j, n=None: rounds[j]


def _lazy_round_draws(keys):
    """As `_round_draws`, of whatever length the port asks for (the
    multistage stage-2 rows grow with a retry's capacity_scale)."""
    keys, subs, memo = list(keys), [], {}
    wide = jax.numpy.asarray(0.5).dtype == np.float64   # made under x64

    def draws(j, n):
        with _x64(wide):
            while len(subs) <= j:
                split = [jr.split(key) for key in keys]
                keys[:] = [a for a, _ in split]
                subs.append([b for _, b in split])
            if (j, n) not in memo:
                memo[j, n] = np.stack([np.asarray(jr.uniform(sub, (n,)))
                                       for sub in subs[j]])
        return memo[j, n]
    return draws


def reference_draws(ref_spec: RefSortSpec, p: int, n: int):
    """The reference's draws for a sort of n keys per request under
    ref_spec, numbered as the port's partitioners take them."""
    n_local = -(-n // p)
    keys = [jr.fold_in(jr.key(ref_spec.seed), s) for s in range(p)]
    algo = ref_spec.algorithm
    if algo in ("sample_random", "ams"):
        u = np.stack([np.asarray(jr.uniform(key, (n_local,)))
                      for key in keys])
        return lambda j, n=None: u
    if algo == "multistage":
        r1 = ref_spec.mesh.shape["outer"]
        k1 = ref_spec.hss_config().resolved_rounds(r1)
        halves = [jr.split(key) for key in keys]
        stage1 = _lazy_round_draws([a for a, _ in halves])
        stage2 = _lazy_round_draws([b for _, b in halves])
        return lambda j, n: (stage1(j, n) if j < k1
                             else stage2(j - k1, n))
    # HSS: one split a round, as many rounds as the port asks for (the
    # imbalance SLO's refine rung runs two more than the spec's)
    return _lazy_round_draws(keys)


def port_hss_config(cfg: HSSConfig, policy: str | None = None):
    return TorchHSSConfig(
        eps=cfg.eps, rounds=cfg.rounds, sample_per_shard=cfg.sample_per_shard,
        adaptive=cfg.adaptive, out_slack=cfg.out_slack,
        capacity_scale=cfg.capacity_scale,
        kernel_policy=policy or _POLICY[cfg.kernel_policy])


def port_exchange_config(cfg: ExchangeConfig, policy: str | None = None):
    return TorchExchangeConfig(
        strategy=cfg.strategy, pair_factor=cfg.pair_factor,
        out_slack=cfg.out_slack, capacity_scale=cfg.capacity_scale,
        kernel_policy=policy or _POLICY[cfg.kernel_policy])


_POLICY = {"auto": "auto", "pallas": "kernel", "xla": "torch"}


def port_spec(ref: RefSortSpec, p: int, **overrides) -> tsort.SortSpec:
    """The port's SortSpec for a reference spec, field by field."""
    fields = dict(
        algorithm=ref.algorithm, eps=ref.eps, rounds=ref.rounds,
        sample_per_shard=ref.sample_per_shard, adaptive=ref.adaptive,
        exchange=ref.exchange, pair_factor=ref.pair_factor,
        out_slack=ref.out_slack, on_overflow=ref.on_overflow,
        max_overflow_retries=ref.max_overflow_retries,
        capacity_scale=ref.capacity_scale, stable=ref.stable, tag=ref.tag,
        kernel_policy=_POLICY[ref.kernel_policy], seed=ref.seed,
        initial_probes=ref.initial_probes, total_sample=ref.total_sample,
        s=ref.s, verify=ref.verify, on_verify_failure=ref.on_verify_failure,
        imbalance_slo=ref.imbalance_slo, semisort_sample=ref.semisort_sample,
        heavy_fraction=ref.heavy_fraction, shards=p, device="cpu")
    if ref.mesh is not None and len(ref.mesh.shape) == 2:
        fields["stages"] = (ref.mesh.shape[ref.outer_axis],
                            ref.mesh.shape[ref.inner_axis])
    fields.update(overrides)
    return tsort.SortSpec(**fields)


def random_keys(dtype, shape, seed: int) -> np.ndarray:
    """Full-range int32/uint32 keys (below the uint32 sentinel) or
    standard-normal float32 keys."""
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.standard_normal(shape).astype(np.float32)
    if dtype == np.uint32:
        return rng.integers(0, 2 ** 32 - 1, size=shape, dtype=np.uint32)
    return rng.integers(-2 ** 31, 2 ** 31 - 1, size=shape, dtype=np.int32)


def _x64(on: bool):
    return jax.enable_x64(True) if on else contextlib.nullcontext()


def _run_both(ref_fn, port_fn, n: int, p: int, port_overrides, x64: bool,
              spec_kw):
    """(port, reference) results of one front-door call: the reference
    under `ref_spec` (x64 if asked; multistage on a 2-D mesh of `stages`,
    default factor_stages(p)), the port under its counterpart with the
    reference's draws injected."""
    spec_kw = dict(spec_kw)
    stages = spec_kw.pop("stages", None)
    if spec_kw.get("algorithm") == "multistage":
        mesh = auto_mesh2d(*(stages or rdriver.factor_stages(p)))
    else:
        mesh = auto_mesh(p)
    ref_spec = RefSortSpec(mesh=mesh, **spec_kw)
    with _x64(x64):
        want = ref_fn(ref_spec)
        draws = reference_draws(ref_spec, p, n)
    got = port_fn(port_spec(ref_spec, p, **(port_overrides or {})), draws)
    return got, want


def sort_batched_both(xs, p: int, port_overrides=None, x64=False,
                      **spec_kw):
    """(port, reference) BatchedSortOutputs of one (B, n) batch."""
    return _run_both(lambda s: rsort.sort_batched(xs, s),
                     lambda s, u: tsort.sort_batched(xs, s, uniform=u),
                     xs.shape[1], p, port_overrides, x64, spec_kw)


def sort_both(x, p: int, port_overrides=None, x64=False, **spec_kw):
    """(port, reference) SortOutputs of one 1-D key array."""
    return _run_both(lambda s: rsort.sort(x, s),
                     lambda s, u: tsort.sort(x, s, uniform=u),
                     x.shape[0], p, port_overrides, x64, spec_kw)


def argsort_both(x, p: int, port_overrides=None, x64=False, **spec_kw):
    """(port, reference) argsort permutations."""
    return _run_both(lambda s: rsort.argsort(x, s),
                     lambda s, u: tsort.argsort(x, s, uniform=u),
                     x.shape[0], p, port_overrides, x64, spec_kw)


def sort_kv_both(keys, values, p: int, port_overrides=None, x64=False,
                 **spec_kw):
    """(port, reference) (sorted_keys, sorted_values) pairs."""
    return _run_both(lambda s: rsort.sort_kv(keys, values, s),
                     lambda s, u: tsort.sort_kv(keys, values, s, uniform=u),
                     keys.shape[0], p, port_overrides, x64, spec_kw)


def to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.uint32:
            return a.view(torch.int32).numpy().view(np.uint32)
        return a.numpy()
    return np.asarray(a)


def _bits(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return a.view(np.dtype(f"i{a.dtype.itemsize}"))
    return a


def assert_bits_equal(got, want, what: str = ""):
    got, want = to_numpy(got), to_numpy(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def assert_counters_equal(got, want, what: str = "", x64: bool = False):
    """An integer counter: bits and dtype, or by value under x64 (where
    the reference widens counters to int64)."""
    if not x64:
        assert_bits_equal(got, want, what)
        return
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64), err_msg=what)


def assert_stats_equal(got, want, x64: bool = False):
    if want is None:
        assert got is None
        return
    for name in want._fields:
        assert_counters_equal(getattr(got, name), getattr(want, name), name,
                              x64)


def assert_recovery_equal(got, want):
    """RecoveryStats field for field (None against None)."""
    if want is None:
        assert got is None
        return
    assert got is not None
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def assert_sort_outputs_equal(got, want, x64: bool = False):
    """Every field of a port SortOutput against the reference's (its
    gathers run under x64 too when it ran so)."""
    with _x64(x64):
        _assert_sort_outputs_equal(got, want, x64)


def _assert_sort_outputs_equal(got, want, x64):
    for name in ("shards", "splitter_keys"):
        assert_bits_equal(getattr(got, name), getattr(want, name), name)
    for name in ("counts", "splitter_ranks", "overflow"):
        assert_counters_equal(getattr(got, name), getattr(want, name), name,
                              x64)
    assert (got.indices is None) == (want.indices is None)
    if want.indices is not None:
        assert_bits_equal(got.indices, want.indices, "indices")
        assert_bits_equal(got.gather_indices(), want.gather_indices(),
                          "gather_indices")
    assert_stats_equal(got.stats, want.stats, x64)
    assert_bits_equal(got.gather(), want.gather(), "gather")
    assert_recovery_equal(got.recovery, want.recovery)


def assert_batched_outputs_equal(got, want, x64: bool = False):
    """Every field of a port BatchedSortOutput against the reference's,
    and every request's gather (under x64 when the reference ran so)."""
    with _x64(x64):
        _assert_batched_outputs_equal(got, want, x64)


def _assert_batched_outputs_equal(got, want, x64):
    assert got.batch == want.batch
    for name in ("shards", "splitter_keys"):
        assert_bits_equal(getattr(got, name), getattr(want, name), name)
    for name in ("counts", "splitter_ranks", "overflow"):
        assert_counters_equal(getattr(got, name), getattr(want, name), name,
                              x64)
    assert (got.indices is None) == (want.indices is None)
    if want.indices is not None:
        assert_bits_equal(got.indices, want.indices, "indices")
    assert_stats_equal(got.stats, want.stats, x64)
    assert_recovery_equal(got.recovery, want.recovery)
    for b in range(want.batch):
        assert_bits_equal(got.gather(b), want.gather(b), f"gather({b})")
        if want.indices is not None:
            assert_bits_equal(got.gather_indices(b), want.gather_indices(b),
                              f"gather_indices({b})")


def semisort_both(x, p: int, port_overrides=None, x64=False, **spec_kw):
    """(port, reference) SemisortOutputs of one 1-D key array (under x64
    the reference's heavy stats are read under x64 too)."""
    def ref(s):
        out = rsort.semisort(x, spec=s)
        out.heavy_keys     # materialise while x64 is as it ran
        return out
    return _run_both(ref, lambda s, u: tsort.semisort(x, spec=s, uniform=u),
                     x.shape[0], p, port_overrides, x64, spec_kw)


def semisort_batched_both(xs, p: int, port_overrides=None, x64=False,
                          **spec_kw):
    """(port, reference) BatchedSemisortOutputs of one (B, n) batch."""
    def ref(s):
        out = rsort.semisort_batched(xs, s)
        out.heavy_keys
        return out
    return _run_both(ref,
                     lambda s, u: tsort.semisort_batched(xs, s, uniform=u),
                     xs.shape[1], p, port_overrides, x64, spec_kw)


def groupby_both(keys, values, op: str, p: int, port_overrides=None,
                 x64=False, **spec_kw):
    """(port, reference) (uniq_keys, aggregates) of `groupby_aggregate`."""
    return _run_both(
        lambda s: rsort.groupby_aggregate(keys, values, op=op, spec=s),
        lambda s, u: tsort.groupby_aggregate(keys, values, op=op, spec=s,
                                             uniform=u),
        keys.shape[0], p, port_overrides, x64, spec_kw)


def top_k_both(x, k: int, p: int, port_overrides=None, **spec_kw):
    """(port, reference) top-k arrays (no draws: top_k samples nothing)."""
    return _run_both(lambda s: rsort.top_k(x, k, s),
                     lambda s, u: tsort.top_k(x, k, s),
                     x.shape[-1], p, port_overrides, False, spec_kw)


def top_k_batched_both(xs, k: int, p: int, port_overrides=None, **spec_kw):
    return _run_both(lambda s: rsort.top_k_batched(xs, k, s),
                     lambda s, u: tsort.top_k_batched(xs, k, s),
                     xs.shape[-1], p, port_overrides, False, spec_kw)


def chaotic(fn, chaos, plan: dict):
    """fn under `chaos.FaultPlan(**plan)` (either package's chaos module):
    returns (fn's result, chaos.stats() at its end)."""
    def run(*args):
        with chaos.activate(chaos.FaultPlan(**plan)):
            out = fn(*args)
            return out, chaos.stats()
    return run


def assert_audit_equal(got, want):
    """Every field of an AuditReport, and the audit vector behind it
    (the port's int64 words against the reference's uint32 ones)."""
    assert (got is None) == (want is None)
    if want is None:
        return
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, (np.ndarray, np.generic)):
            assert_bits_equal(np.asarray(g), np.asarray(w), f.name)
        else:
            assert g == w, (f.name, g, w)


def assert_audit_vec_equal(got_out, want_out):
    want = np.asarray(want_out._audit_vec)
    got = to_numpy(got_out._audit_vec)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(np.int64))


def assert_semisort_equal(got, want, x64: bool = False):
    """A port SemisortOutput against the reference's: heavy keys and
    counts, the light SortOutput field for field (its splitter stats
    inside the semisort stats), and the grouped gather."""
    with _x64(x64):
        assert_bits_equal(got.heavy_keys, want.heavy_keys, "heavy_keys")
        assert_counters_equal(got.heavy_counts, want.heavy_counts,
                              "heavy_counts", x64)
        assert got.n == want.n
        gl, wl = got.light, want.light
        for name in ("shards", "splitter_keys"):
            assert_bits_equal(getattr(gl, name), getattr(wl, name), name)
        for name in ("counts", "splitter_ranks", "overflow"):
            assert_counters_equal(getattr(gl, name), getattr(wl, name), name,
                                  x64)
        stats = getattr(wl.stats, "splitter", wl.stats)
        assert_stats_equal(getattr(gl.stats, "splitter", gl.stats), stats,
                           x64)
        assert_bits_equal(got.gather(), want.gather(), "gather")
