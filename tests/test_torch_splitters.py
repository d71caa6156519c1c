"""HSS splitters and the dense exchange against the reference, bit for bit.

With the reference's own per-shard draws injected, the port's
`hss_sort_sharded` (local sort -> `hss_splitters` -> dense `exchange`)
must reproduce `repro.core.hss.hss_sort` exactly: shards, counts,
splitter keys and ranks, overflow, and every SplitterStats field. The
dense exchange is also held alone to the reference's, run in shard_map,
including send-side overflow and receive-side truncation. The Comm call
log is held to the reference's collective contracts.
"""
import importlib

import jax
import jax.numpy as jnp
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
from repro_torch.parallel.comm import Comm
from torch_parity import (
    assert_bits_equal, assert_stats_equal, auto_mesh, port_exchange_config,
    port_hss_config, reference_uniform)

# repro.core re-exports a function named `exchange`, which shadows the
# submodule as a package attribute
rex = importlib.import_module("repro.core.exchange")
rsp = importlib.import_module("repro.core.splitters")

N_LOCAL = 1024


def _run_both(x, p, cfg, ex_cfg=None, probes=None, policy=None):
    ex_cfg = ex_cfg or rex.ExchangeConfig()
    want = hss_sort(jnp.asarray(x), mesh=auto_mesh(p), hss_cfg=cfg,
                    ex_cfg=ex_cfg, seed=0,
                    initial_probes=None if probes is None
                    else jnp.asarray(probes))
    comm = Comm(p)
    draws = reference_uniform(0, p, x.shape[0] // p, cfg.resolved_rounds(p))
    got = hss_sort_sharded(
        torch.from_numpy(x).reshape(p, -1), comm=comm,
        uniform=lambda j: torch.from_numpy(draws(j)),
        hss_cfg=port_hss_config(cfg, policy),
        ex_cfg=port_exchange_config(ex_cfg, policy),
        initial_probes=None if probes is None else torch.from_numpy(probes))
    return got, want, comm


def _assert_result_equal(got, want):
    for name in ("shards", "counts", "splitter_keys", "splitter_ranks",
                 "overflow"):
        assert_bits_equal(getattr(got, name), getattr(want, name), name)
    assert_stats_equal(got.stats, want.stats)


@pytest.mark.parametrize("cfg", [
    HSSConfig(),
    HSSConfig(adaptive=False),
    HSSConfig(rounds=2, eps=0.02),
    HSSConfig(sample_per_shard=8),      # sample buffers overflow
    HSSConfig(eps=0.2, capacity_scale=2.0),
], ids=["default", "fixed_ratios", "two_rounds", "tiny_sample", "scaled"])
@pytest.mark.parametrize("p", [2, 8])
def test_hss_sort_sharded_matches_reference(cfg, p):
    x = make_distribution("GAUSS", p * N_LOCAL, seed=p)
    got, want, _ = _run_both(x, p, cfg)
    _assert_result_equal(got, want)


def test_kernel_policy_matches_reference():
    x = make_distribution("SKEW3", 4 * N_LOCAL, seed=1)
    got, want, _ = _run_both(x, 4, HSSConfig(), policy="kernel")
    _assert_result_equal(got, want)


@pytest.mark.parametrize("name", ["full_int32", "repeated_int64"])
def test_tagged_int64_sort_on_the_card_route_matches_reference(monkeypatch,
                                                               name):
    """tag=True on keys whose pack is int64, with "auto" resolved as on the
    card ("kernel" refuses 64-bit local sorts, which sort on torch.sort):
    each splitter round's sample runs K6's int64 plain version, the
    searches and merges K4s's and K5's. Bit for bit against the
    reference's sort under x64 with its draws injected: shards, counts,
    splitter keys and ranks, every SplitterStats field."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.sample import kernel as tsk
    from torch_parity import assert_sort_outputs_equal, sort_both

    rng = np.random.default_rng(31)
    n = 8 * N_LOCAL
    if name == "full_int32":
        x = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    else:
        x = rng.integers(0, 2 ** 40, 300)[rng.integers(0, 300, n)]
    resolve, plain = dispatch.resolve_policy, tsk.sample_compact_plain
    calls = []

    def counted(keys, *args):
        calls.append(keys.dtype)
        return plain(keys, *args)

    monkeypatch.setattr(dispatch, "resolve_policy",
                        lambda policy, device, dtype=None, *, wide=False:
                        resolve(policy, "cuda", dtype, wide=wide))
    monkeypatch.setattr(tsk, "sample_compact_plain", counted)
    got, want = sort_both(x, 8, x64=True, tag=True)
    assert_sort_outputs_equal(got, want, x64=True)
    assert got.indices.dtype == torch.int64
    assert calls and set(calls) == {torch.int64}


def test_warm_start_matches_reference():
    x = make_distribution("UNIF", 8 * N_LOCAL, seed=2)
    probes = np.sort(x[::997])[:40]
    got, want, _ = _run_both(x, 8, HSSConfig(), probes=probes)
    _assert_result_equal(got, want)


def test_collective_log_matches_contracts():
    """1 all_gather + 1 psum per non-converged round
    (repro.core.splitters.ROUND_COLLECTIVES), plus the dense exchange's
    2 all_to_all + 2 psum (EXCHANGE_COLLECTIVES["dense"])."""
    p = 8
    x = make_distribution("UNIF", p * N_LOCAL, seed=3)
    cfg = HSSConfig(eps=0.01)
    got, want, comm = _run_both(x, p, cfg)
    _assert_result_equal(got, want)
    k = cfg.resolved_rounds(p)
    rounds_run = int(got.stats.rounds_used)
    assert 1 <= rounds_run <= k
    exchange = rex.EXCHANGE_COLLECTIVES["dense"]
    expect = {name: rsp.ROUND_COLLECTIVES.get(name, 0) * rounds_run
              + exchange.get(name, 0) for name in ("all_gather", "psum",
                                                   "all_to_all")}
    assert dict(comm.log) == {k_: v for k_, v in expect.items() if v}
    assert tsp.ROUND_COLLECTIVES == rsp.ROUND_COLLECTIVES
    assert tex.EXCHANGE_COLLECTIVES["dense"] == exchange


def test_pure_helpers_match_reference(rng):
    """refine / active_union_size / gamma_membership / choose_splitters on
    one hand-made state."""
    p, n = 8, 8000
    targets_r = rsp.splitter_targets(n, p)
    targets_t = tsp.splitter_targets(n, p)
    assert_bits_equal(targets_t, targets_r)
    probes = np.sort(rng.integers(0, 10 ** 6, 64)).astype(np.int32)
    ranks = np.sort(rng.integers(0, n, 64)).astype(np.int32)
    rs = rsp.refine(rsp.init_state(p, n, jnp.int32), jnp.asarray(probes),
                    jnp.asarray(ranks), targets_r, jnp.int32(200))
    ts = tsp.refine(tsp.init_state(p, n, torch.int32),
                    torch.from_numpy(probes), torch.from_numpy(ranks),
                    targets_t, 200)
    for a, b in zip(ts, rs):
        assert_bits_equal(a, b)
    assert_bits_equal(tsp.active_union_size(ts, targets_t),
                      rsp.active_union_size(rs, targets_r))
    x = rng.integers(0, 10 ** 6, (2, 500)).astype(np.int32)
    assert_bits_equal(tsp.gamma_membership(torch.from_numpy(x), ts),
                      np.stack([np.asarray(rsp.gamma_membership(
                          jnp.asarray(row), rs)) for row in x]))
    for a, b in zip(tsp.choose_splitters(ts, targets_t),
                    rsp.choose_splitters(rs, targets_r)):
        assert_bits_equal(a, b)


def _ref_exchange(rows, keys, cfg, eps):
    p = rows.shape[0]

    def body(local, k):
        out, nv, ovf = rex.exchange_dense(local.reshape(-1), k,
                                          axis_name="sort", p=p, cfg=cfg,
                                          eps=eps)
        return out[None], jnp.asarray(nv, jnp.int32)[None], ovf

    fn = jax.jit(shard_map(body, mesh=auto_mesh(p), in_specs=(P("sort"), P()),
                           out_specs=(P("sort"), P("sort"), P())))
    return fn(jnp.asarray(rows), jnp.asarray(keys))


@pytest.mark.parametrize("case", ["balanced", "send_overflow",
                                  "receive_truncation"])
def test_exchange_dense_matches_reference(rng, case):
    p, n = 4, 512
    rows = np.sort(rng.integers(0, 10 ** 6, (p, n)), axis=-1).astype(np.int32)
    keys = np.quantile(rows, [0.25, 0.5, 0.75]).astype(np.int32)
    cfg, eps = rex.ExchangeConfig(), 0.05
    if case == "send_overflow":
        cfg = rex.ExchangeConfig(pair_factor=0.5)
    elif case == "receive_truncation":
        keys = np.array([10, 20, 30], np.int32)   # everything to the last
    want = _ref_exchange(rows, keys, cfg, eps)
    comm = Comm(p)
    got = tex.exchange(torch.from_numpy(rows), torch.from_numpy(keys),
                       comm=comm, cfg=port_exchange_config(cfg), eps=eps)
    for a, b, name in zip(got, want, ("out", "n_valid", "overflow")):
        assert_bits_equal(a, b, name)
    if case != "balanced":
        assert int(got[2]) > 0
    assert dict(comm.log) == {"all_to_all": 2, "psum": 2}
