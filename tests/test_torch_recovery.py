"""Overflow recovery against the reference, bit for bit: `sort` and
`sort_batched` under on_overflow="retry" and "spill" (shards, counts,
overflow, splitter keys and ranks, stats and every RecoveryStats field),
the dense_spill exchange against the reference's in shard_map, its
collective log, and the RuntimeError after a truncating spill attempt.

The reference's draws are injected; every attempt of a retry reseeds from
the spec's seed in both packages, so the one stream serves them all.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.sort as rsort
import repro_torch.sort as tsort
from repro.parallel.compat import shard_map
from repro_torch.core import exchange as tex
from repro_torch.data import distributions as tdist
from repro_torch.parallel.comm import Comm
from torch_parity import (
    assert_batched_outputs_equal, assert_bits_equal,
    assert_sort_outputs_equal, auto_mesh, port_exchange_config, port_spec,
    sort_batched_both, sort_both)

rex = importlib.import_module("repro.core.exchange")

N = 8192


def _keys(name, n, dtype, seed=1):
    """PRESORTED, REVERSE and ALL_EQUAL from the adversarial family, UNIF
    from the paper's, as int32, uint32 or float32."""
    if name == "UNIF":
        x = tdist.make_distribution(name, n, seed=seed)
    else:
        x = tdist.make_adversarial(name, n, seed=seed)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("name", ["PRESORTED", "REVERSE", "ALL_EQUAL",
                                  "UNIF"])
@pytest.mark.parametrize("policy", ["retry", "spill"])
def test_sort_recovery_matches_reference(policy, name, dtype):
    x = _keys(name, N, dtype)
    got, want = sort_both(x, 8, on_overflow=policy)
    assert_sort_outputs_equal(got, want)
    assert int(got.overflow) == 0
    np.testing.assert_array_equal(got.gather(), np.sort(x))
    if policy == "retry" and name != "UNIF":
        assert got.recovery.attempts > 1
        assert got.recovery.recovered_overflow > 0


def test_raise_drops_what_retry_recovers():
    """The same presorted keys: "raise" reports the reference's overflow,
    "retry" recovers exactly that many keys."""
    x = _keys("PRESORTED", N, np.int32)
    raised, want = sort_both(x, 8)
    assert_sort_outputs_equal(raised, want)
    assert int(raised.overflow) > 0
    retried, _ = sort_both(x, 8, on_overflow="retry")
    assert retried.recovery.recovered_overflow == int(raised.overflow)
    assert retried.recovery.escalations == (2.0, 4.0)


@pytest.mark.parametrize("p", [2, 3, 4])
def test_retry_with_spill_attempt_matches_reference(p):
    """One escalation is not enough: the last attempt runs on the spill
    channel (spill_fallback=True), warm-started and at the escalated
    capacity."""
    x = _keys("REVERSE", 4099, np.int32)
    got, want = sort_both(x, p, on_overflow="retry", max_overflow_retries=1,
                          pair_factor=0.25)
    assert_sort_outputs_equal(got, want)
    assert got.recovery.spill_fallback
    np.testing.assert_array_equal(got.gather(), np.sort(x))


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("policy", ["retry", "spill"])
def test_sort_batched_recovery_matches_reference(policy, dtype):
    """Rows of different kinds in one batch: presorted, reversed and
    uniform. The batch shares one plan and one policy."""
    xs = np.stack([_keys(name, 4096, dtype, seed=b) for b, name in
                   enumerate(["PRESORTED", "REVERSE", "UNIF"])])
    got, want = sort_batched_both(xs, 8, on_overflow=policy)
    assert_batched_outputs_equal(got, want)
    assert not got.overflow.any()
    for b in range(xs.shape[0]):
        np.testing.assert_array_equal(got.gather(b), np.sort(xs[b]))
        assert got.request(b).recovery == got.recovery


@pytest.mark.parametrize("policy", ["retry", "spill"])
def test_sort_batched_recovery_stable_matches_reference(policy):
    """stable=True over a batch whose key range needs int64 packing (30
    key bits + 12 tag bits; the reference under x64): an all-equal row
    becomes index order, which only recovery makes exact."""
    xs = np.stack([_keys(name, 4096, np.int32, seed=b) for b, name in
                   enumerate(["ALL_EQUAL", "REVERSE", "UNIF"])])
    got, want = sort_batched_both(xs, 8, x64=True, on_overflow=policy,
                                  stable=True)
    assert_batched_outputs_equal(got, want, x64=True)
    assert got.indices.dtype == torch.int64
    assert not got.overflow.any()
    for b in range(xs.shape[0]):
        np.testing.assert_array_equal(got.gather_indices(b),
                                      np.argsort(xs[b], kind="stable"))


def test_sort_batched_list_input_recovers_per_bucket():
    """List input: one batch per length, each under the policy, in input
    order."""
    arrs = [_keys("PRESORTED", 4096, np.int32),
            _keys("REVERSE", 4099, np.int32),
            _keys("UNIF", 4096, np.int32)]
    spec = tsort.SortSpec(device="cpu", shards=8, on_overflow="retry")
    outs = tsort.sort_batched(arrs, spec)
    for a, o in zip(arrs, outs):
        np.testing.assert_array_equal(o.gather(), np.sort(a))
        assert o.recovery.attempts > 1
    ref = rsort.sort_batched(arrs, rsort.SortSpec(mesh=auto_mesh(8),
                                                  on_overflow="retry"))
    for o, r in zip(outs, ref):
        np.testing.assert_array_equal(o.gather(), r.gather())


def test_truncating_spill_attempt_raises():
    """out_slack far below the balanced load: every attempt truncates at
    out_cap, and the retry policy raises after its spill attempt, as the
    reference's does."""
    x = _keys("UNIF", 4096, np.int32)
    kw = dict(on_overflow="retry", out_slack=0.1)
    with pytest.raises(RuntimeError, match="unrecovered"):
        rsort.sort(x, rsort.SortSpec(mesh=auto_mesh(4), **kw))
    with pytest.raises(RuntimeError, match="unrecovered"):
        tsort.sort(x, tsort.SortSpec(device="cpu", shards=4, **kw))


def test_spec_resolves_the_spill_exchange():
    spec = tsort.SortSpec(on_overflow="spill")
    assert spec.resolved_exchange() == "dense_spill"
    assert spec.exchange_config().strategy == "dense_spill"
    assert spec.overflow_structurally_zero()
    assert tsort.SortSpec(on_overflow="spill",
                          exchange="allgather").resolved_exchange() \
        == "allgather"
    assert not tsort.SortSpec().overflow_structurally_zero()
    for kw in (dict(on_overflow="spill"), dict(exchange="dense_spill"),
               dict(exchange="allgather"), dict()):
        ref = rsort.SortSpec(**kw)
        ours = port_spec(ref, 8)
        assert ours.resolved_exchange() == ref.resolved_exchange()
        assert (ours.overflow_structurally_zero()
                == ref.overflow_structurally_zero())
    assert tsort.SortSpec().max_overflow_retries \
        == rsort.SortSpec().max_overflow_retries


def test_dense_spill_exchange_through_sort_matches_reference():
    """exchange="dense_spill" in its own right, ragged n, p = 3."""
    x = _keys("REVERSE", 4099, np.float32)
    got, want = sort_both(x, 3, exchange="dense_spill")
    assert_sort_outputs_equal(got, want)
    np.testing.assert_array_equal(got.gather(), np.sort(x))


# ------------------------------------------------- the dense_spill exchange
def _ref_spill(rows, keys, cfg, eps, n_valid):
    p = rows.shape[0]

    def body(local, k, nv):
        out, n_out, ovf = rex.exchange_dense_spill_batched(
            local[0], k, axis_name="sort", p=p, cfg=cfg, eps=eps,
            n_valid=nv)
        return out[None], jnp.asarray(n_out, jnp.int32)[None], ovf

    f = jax.jit(shard_map(body, mesh=auto_mesh(p),
                          in_specs=(P("sort"), P(), P()),
                          out_specs=(P("sort"), P("sort"), P())))
    return f(jnp.asarray(rows), jnp.asarray(keys), jnp.asarray(n_valid))


def _spill_case(p, batch=3, n=512, seed=0):
    """(p, B, n) sorted rows and (B, p-1) splitters. Request 0 is balanced
    (no key spills); request 1 sends every key of each shard to shard 0,
    so all but pair_cap of them spill (and out_cap truncates); request 2 is
    presorted (each shard's keys to its own destination). The last 37
    slots of every row are sentinel padding past n_valid."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, 10 ** 6, (p, batch, n)), axis=-1)
    keys = np.stack([np.quantile(rows[:, b], np.linspace(0, 1, p + 1)[1:-1])
                     for b in range(batch)])
    keys[1] = 10 ** 7 + np.arange(p - 1)             # all to shard 0
    rows[:, 2] = np.arange(p * n).reshape(p, n)
    keys[2] = np.arange(1, p) * n
    rows[:, :, -37:] = np.iinfo(np.int32).max
    n_valid = np.full((batch,), n - 37, np.int32)
    return rows.astype(np.int32), keys.astype(np.int32), n_valid


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_exchange_dense_spill_batched_matches_reference(p):
    rows, keys, n_valid = _spill_case(p, seed=p)
    cfg, eps = rex.ExchangeConfig(strategy="dense_spill"), 0.05
    cap = cfg.pair_cap(rows.shape[-1], p)
    want = _ref_spill(rows, keys, cfg, eps, n_valid)
    comm = Comm(p)
    got = tex.exchange_batched(
        torch.from_numpy(rows), torch.from_numpy(keys), comm=comm,
        cfg=port_exchange_config(cfg), eps=eps,
        n_valid=torch.from_numpy(n_valid))
    for a, b, name in zip(got, want, ("out", "n_valid", "overflow")):
        assert_bits_equal(a, b, name)
    n_out = got[1].numpy()
    assert n_out[:, 0].sum() == n_out[:, 2].sum() == p * int(n_valid[0])
    assert n_out[0, 1] > cap                  # request 1's spilled keys
    # B = 3 requests, one request's collectives each
    batch = rows.shape[1]
    assert dict(comm.log) == {
        k: batch * v for k, v in rex.EXCHANGE_COLLECTIVES["dense_spill"]
        .items() if v}


def test_exchange_dense_spill_unbatched_matches_reference():
    """The unbatched `exchange` is the batched one at B = 1; a request
    with no spill at all gives the dense exchange's result."""
    p, n = 4, 600
    rng = np.random.default_rng(7)
    rows = np.sort(rng.integers(0, 10 ** 6, (p, n)), axis=-1).astype(np.int32)
    keys = np.quantile(rows, np.linspace(0, 1, p + 1)[1:-1]).astype(np.int32)
    cfg, eps = rex.ExchangeConfig(strategy="dense_spill"), 0.05

    def body(local, k):
        out, nv, ovf = rex.exchange_dense_spill(
            local.reshape(-1), k, axis_name="sort", p=p, cfg=cfg, eps=eps)
        return out[None], jnp.asarray(nv, jnp.int32)[None], ovf

    fn = jax.jit(shard_map(body, mesh=auto_mesh(p), in_specs=(P("sort"), P()),
                           out_specs=(P("sort"), P("sort"), P())))
    want = fn(jnp.asarray(rows), jnp.asarray(keys))
    comm = Comm(p)
    got = tex.exchange(torch.from_numpy(rows), torch.from_numpy(keys),
                       comm=comm, cfg=port_exchange_config(cfg), eps=eps)
    for a, b, name in zip(got, want, ("out", "n_valid", "overflow")):
        assert_bits_equal(a, b, name)
    dense = tex.exchange(torch.from_numpy(rows), torch.from_numpy(keys),
                         comm=Comm(p), cfg=tex.ExchangeConfig(), eps=eps)
    for a, b in zip(got, dense):
        assert torch.equal(a, b)
    assert dict(comm.log) == {k: v for k, v in
                              rex.EXCHANGE_COLLECTIVES["dense_spill"].items()
                              if v}
