"""The batched core against the reference, bit for bit: `hss_splitters_batched`
with the reference's draws injected (a (B, m) warm start included), the
batched dense and allgather exchanges and the unbatched allgather exchange,
each against the reference run in shard_map on the Auto mesh; and the
`Comm` log, which must show the same collective counts at B = 1 and B = 8.

Layout: the reference's shard s holds a (B, n_local) block; the port holds
all shards as one (p, B, n_local) tensor, so row (s, b) of the port is row
b of the reference's shard s.
"""
import importlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core.common import HSSConfig
from repro.core.hss import hss_sort
from repro.data.distributions import make_distribution
from repro.parallel.compat import shard_map
from repro_torch.core import exchange as tex
from repro_torch.core import splitters as tsp
from repro_torch.core.hss import hss_sort_sharded
from repro_torch.kernels import dispatch as td
from repro_torch.parallel.comm import Comm
from repro_torch.sort.partitioners import null_stats_batched
from torch_parity import (
    assert_bits_equal, assert_stats_equal, auto_mesh, port_exchange_config,
    port_hss_config, reference_uniform)

rex = importlib.import_module("repro.core.exchange")
rsp = importlib.import_module("repro.core.splitters")
rpart = importlib.import_module("repro.sort.partitioners")

N_LOCAL = 512
NAMES = ["GAUSS", "UNIF", "SKEW3", "SKEW1", "UNIF", "GAUSS", "SKEW3", "UNIF"]


def _shards(p, batch, n_local=N_LOCAL, seed=0):
    """(p, B, n_local) sorted shard rows: request b is one distribution,
    cut into p contiguous shards as the driver lays it out."""
    reqs = np.stack([make_distribution(NAMES[b % len(NAMES)], p * n_local,
                                       seed=seed + b)
                     for b in range(batch)])
    rows = reqs.reshape(batch, p, n_local).transpose(1, 0, 2)
    return np.ascontiguousarray(np.sort(rows, axis=-1))


def _ref_splitters(rows, cfg, probes=None, seed=0):
    p = rows.shape[0]

    def body(local):
        rng = jr.fold_in(jr.key(seed), jax.lax.axis_index("sort"))
        return rsp.hss_splitters_batched(
            local[0], axis_name="sort", p=p, cfg=cfg, rng=rng,
            initial_probes=None if probes is None else jnp.asarray(probes))

    fn = jax.jit(shard_map(body, mesh=auto_mesh(p), in_specs=(P("sort"),),
                           out_specs=(P(), P(), P())))
    return fn(jnp.asarray(rows))


def _port_splitters(rows, cfg, probes=None, policy=None, comm=None):
    p, _, n_local = rows.shape
    comm = comm or Comm(p)
    draws = reference_uniform(0, p, n_local, cfg.resolved_rounds(p))
    return tsp.hss_splitters_batched(
        torch.from_numpy(rows), comm=comm, cfg=port_hss_config(cfg, policy),
        uniform=lambda j: torch.from_numpy(draws(j)),
        initial_probes=None if probes is None else torch.from_numpy(probes))


def _assert_splitters_equal(got, want):
    for a, b, name in zip(got[:2], want[:2], ("keys", "ranks")):
        assert_bits_equal(a, b, name)
    assert_stats_equal(got[2], want[2])


@pytest.mark.parametrize("cfg", [
    HSSConfig(),
    HSSConfig(adaptive=False),
    HSSConfig(rounds=2, eps=0.02),
    HSSConfig(sample_per_shard=8),      # sample buffers overflow
], ids=["default", "fixed_ratios", "two_rounds", "tiny_sample"])
@pytest.mark.parametrize("p,batch", [(2, 3), (8, 3)])
def test_hss_splitters_batched_matches_reference(cfg, p, batch):
    rows = _shards(p, batch, seed=p)
    want = _ref_splitters(rows, cfg)
    got = _port_splitters(rows, cfg)
    _assert_splitters_equal(got, want)
    assert got[2].gamma_size.shape == (cfg.resolved_rounds(p), batch)
    assert got[2].rounds_used.shape == (batch,)


def test_hss_splitters_batched_warm_start_matches_reference():
    p, batch = 8, 3
    rows = _shards(p, batch, seed=5)
    flat = rows.transpose(1, 0, 2).reshape(batch, -1)
    probes = np.sort(flat[:, ::97], axis=-1)[:, :24]       # (B, m) rows
    want = _ref_splitters(rows, HSSConfig(), probes=probes)
    got = _port_splitters(rows, HSSConfig(), probes=probes)
    _assert_splitters_equal(got, want)


def test_hss_splitters_batched_kernel_policy_matches_reference():
    rows = _shards(4, 3, seed=9)
    want = _ref_splitters(rows, HSSConfig())
    got = _port_splitters(rows, HSSConfig(), policy="kernel")
    _assert_splitters_equal(got, want)


def test_mixed_convergence_matches_reference():
    """Requests that converge in different rounds: the batch runs until
    every request is satisfied (one host sync per round), the satisfied
    ones included, and each request's stats match the reference's."""
    p = 8
    rows = _shards(p, 3, seed=12)
    cfg = HSSConfig(eps=0.01)
    got = _port_splitters(rows, cfg)
    _assert_splitters_equal(got, _ref_splitters(rows, cfg))
    ru = got[2].rounds_used.numpy()
    assert ru.min() < ru.max()                  # the case is mixed
    b = int(ru.argmin())
    assert (got[2].n_satisfied[ru[b] - 1:, b].numpy() == p - 1).all()


# ------------------------------------------------------------ exchanges
def _ref_exchange_batched(fn, rows, keys, cfg, eps, n_valid=None):
    p = rows.shape[0]

    def body(local, k):
        out, nv, ovf = fn(local[0], k, axis_name="sort", p=p, cfg=cfg,
                          eps=eps, n_valid=None if n_valid is None
                          else jnp.asarray(n_valid))
        return out[None], jnp.asarray(nv, jnp.int32)[None], ovf

    f = jax.jit(shard_map(body, mesh=auto_mesh(p), in_specs=(P("sort"), P()),
                          out_specs=(P("sort"), P("sort"), P())))
    return f(jnp.asarray(rows), jnp.asarray(keys))


def _case(rng, case, p=4, batch=3, n=512):
    rows = np.sort(rng.integers(0, 10 ** 6, (p, batch, n)), axis=-1
                   ).astype(np.int32)
    qs = np.linspace(0, 1, p + 1)[1:-1]
    keys = np.stack([np.quantile(rows[:, b], qs) for b in range(batch)]
                    ).astype(np.int32)
    n_valid = None
    if case == "receive_truncation":
        keys[1] = np.arange(1, p) * 10          # request 1 to the last shard
    elif case == "n_valid":
        rows[:, :, -37:] = np.iinfo(np.int32).max
        n_valid = np.full((batch,), n - 37, np.int32)
    return rows, keys, n_valid


@pytest.mark.parametrize("case", ["balanced", "send_overflow",
                                  "receive_truncation", "n_valid"])
@pytest.mark.parametrize("strategy", ["dense", "allgather"])
def test_exchange_batched_matches_reference(rng, strategy, case):
    rows, keys, n_valid = _case(rng, case)
    cfg, eps = rex.ExchangeConfig(strategy=strategy), 0.05
    if case == "send_overflow":
        cfg = rex.ExchangeConfig(strategy=strategy, pair_factor=0.5)
    ref_fn = {"dense": rex.exchange_dense_batched,
              "allgather": rex.exchange_allgather_batched}[strategy]
    want = _ref_exchange_batched(ref_fn, rows, keys, cfg, eps, n_valid)
    comm = Comm(rows.shape[0])
    got = tex.exchange_batched(
        torch.from_numpy(rows), torch.from_numpy(keys), comm=comm,
        cfg=port_exchange_config(cfg), eps=eps,
        n_valid=None if n_valid is None else torch.from_numpy(n_valid))
    for a, b, name in zip(got, want, ("out", "n_valid", "overflow")):
        assert_bits_equal(a, b, name)
    if case == "receive_truncation" or (case == "send_overflow"
                                         and strategy == "dense"):
        assert int(got[2].max()) > 0
    expect = {k: v for k, v in rex.EXCHANGE_COLLECTIVES[strategy].items()
              if v}
    assert dict(comm.log) == expect


@pytest.mark.parametrize("p", [2, 4])
def test_exchange_allgather_matches_reference(rng, p):
    n = 600
    rows = np.sort(rng.integers(0, 10 ** 6, (p, n)), axis=-1).astype(np.int32)
    keys = np.quantile(rows, np.linspace(0, 1, p + 1)[1:-1]).astype(np.int32)
    cfg, eps = rex.ExchangeConfig(strategy="allgather"), 0.05

    def body(local, k):
        out, nv, ovf = rex.exchange_allgather(local.reshape(-1), k,
                                              axis_name="sort", p=p,
                                              cfg=cfg, eps=eps)
        return out[None], jnp.asarray(nv, jnp.int32)[None], ovf

    fn = jax.jit(shard_map(body, mesh=auto_mesh(p), in_specs=(P("sort"), P()),
                           out_specs=(P("sort"), P("sort"), P())))
    want = fn(jnp.asarray(rows), jnp.asarray(keys))
    comm = Comm(p)
    got = tex.exchange(torch.from_numpy(rows), torch.from_numpy(keys),
                       comm=comm, cfg=port_exchange_config(cfg), eps=eps)
    for a, b, name in zip(got, want, ("out", "n_valid", "overflow")):
        assert_bits_equal(a, b, name)
    assert dict(comm.log) == {"all_gather": 2, "psum": 1}


def test_hss_sort_sharded_allgather_matches_reference():
    """The unbatched core pipeline with the allgather exchange."""
    p = 4
    x = make_distribution("GAUSS", p * N_LOCAL, seed=2)
    cfg, ex_cfg = HSSConfig(), rex.ExchangeConfig(strategy="allgather")
    want = hss_sort(jnp.asarray(x), mesh=auto_mesh(p), hss_cfg=cfg,
                    ex_cfg=ex_cfg, seed=0)
    draws = reference_uniform(0, p, N_LOCAL, cfg.resolved_rounds(p))
    got = hss_sort_sharded(torch.from_numpy(x).reshape(p, -1), comm=Comm(p),
                           uniform=lambda j: torch.from_numpy(draws(j)),
                           hss_cfg=port_hss_config(cfg),
                           ex_cfg=port_exchange_config(ex_cfg))
    for name in ("shards", "counts", "splitter_keys", "splitter_ranks",
                 "overflow"):
        assert_bits_equal(getattr(got, name), getattr(want, name), name)
    assert_stats_equal(got.stats, want.stats)


def test_unported_exchanges_raise():
    """Every reference strategy is ported: an unknown name raises
    ValueError, as the reference's does. The collective tables are the
    reference's, except that ragged batch-fuses (one index gather moves
    every request) and counts its out_cap truncation in one psum."""
    rows = torch.zeros((2, 1, 16), dtype=torch.int32)
    keys = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown exchange"):
        tex.exchange_batched(rows, keys, comm=Comm(2),
                             cfg=tex.ExchangeConfig(strategy="mpi"))
    assert tex.BATCH_FUSED_STRATEGIES == (rex.BATCH_FUSED_STRATEGIES
                                          + ("ragged",))
    ragged = dict(rex.EXCHANGE_COLLECTIVES["ragged"])
    ragged["psum"] += 1
    assert tex.EXCHANGE_COLLECTIVES == {**rex.EXCHANGE_COLLECTIVES,
                                        "ragged": ragged}


# ------------------------------------------------------- collective log
@pytest.mark.parametrize("strategy", ["dense", "allgather"])
def test_collective_log_is_the_same_at_b1_and_b8(strategy):
    """One all_gather + one psum per executed round and the exchange's
    fixed set, whatever B is (the reference's batch-invariant contract,
    BATCH_FUSED_STRATEGIES)."""
    p = 8
    rows8 = _shards(p, 8, seed=21)
    cfg = HSSConfig()
    k = cfg.resolved_rounds(p)
    logs = []
    for rows in (rows8[:, :1], rows8):
        comm = Comm(p)
        local = torch.from_numpy(np.ascontiguousarray(rows))
        keys, _, stats = _port_splitters(np.ascontiguousarray(rows), cfg,
                                         comm=comm)
        tex.exchange_batched(td.local_sort_batched(local), keys, comm=comm,
                             cfg=tex.ExchangeConfig(strategy=strategy))
        ran = int(stats.rounds_used.max())
        assert 1 <= ran <= k
        expect = {name: rsp.ROUND_COLLECTIVES.get(name, 0) * ran
                  + rex.EXCHANGE_COLLECTIVES[strategy].get(name, 0)
                  for name in ("all_gather", "psum", "all_to_all")}
        assert dict(comm.log) == {n: v for n, v in expect.items() if v}
        logs.append(dict(comm.log))
    assert logs[0] == logs[1]


@pytest.mark.parametrize("n_satisfied", [None, [3, 0, 7]])
def test_null_stats_batched_matches_reference(n_satisfied):
    want = rpart.null_stats_batched(3, n_satisfied)
    got = null_stats_batched(3, n_satisfied)
    assert_stats_equal(got, want)
