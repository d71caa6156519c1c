"""Two-stage HSS against the reference, bit for bit: `sort`, `sort_batched`
and `argsort` with algorithm="multistage" on (r1, r2) grids — the default
`factor_stages(p)` and explicit stage shapes — over int32, uint32 and
float32 keys; `hss_splitters_general` (part count apart from shard count,
a per-row traced n over sentinel-padded rows) against the reference's in
shard_map; the (outer, inner) `Comm` views; the collective log against the
reference's per-round counts (multistage.py:66-76); and the overflow,
which the port counts over every group where the reference reads one
shard's. The reference's draws are injected (its shard key split in two,
each stage key split once a round). The benchmark's plain two-stage
reference (`hssbench/reference_two_stage.py`) holds the port's answers on
the (8, 8) and (4, 4) grids to the sorted keys and the stage bounds.
"""
import importlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro_torch.sort as tsort
from repro.parallel.compat import shard_map
from repro_torch.core import exchange as tex
from repro_torch.core import multistage as tms
from repro_torch.core.common import HSSConfig as TorchHSSConfig
from repro_torch.data import distributions as tdist
from repro_torch.parallel.comm import Comm
from repro_torch.sort import driver as tdriver
from hssbench.reference_two_stage import stage_checks
from torch_parity import (
    argsort_both, assert_batched_outputs_equal, assert_bits_equal,
    assert_sort_outputs_equal, auto_mesh, random_keys, sort_batched_both,
    sort_both)

rms = importlib.import_module("repro.core.multistage")
rdriver = importlib.import_module("repro.sort.driver")
rparts = importlib.import_module("repro.sort.partitioners")
rex = importlib.import_module("repro.core.exchange")
rcommon = importlib.import_module("repro.core.common")

N_LOCAL = 2048


@pytest.mark.parametrize("p,stages,dtype", [
    (2, None, np.int32), (3, None, np.uint32), (4, None, np.float32),
    (8, None, np.int32), (8, (4, 2), np.float32), (4, (4, 1), np.int32)])
def test_sort_matches_reference(p, stages, dtype):
    x = random_keys(dtype, p * N_LOCAL + 5, seed=p)
    got, want = sort_both(x, p, algorithm="multistage", stages=stages,
                          tag=False)
    assert_sort_outputs_equal(got, want)
    assert int(got.overflow) == 0
    np.testing.assert_array_equal(got.gather(), np.sort(x))


@pytest.mark.parametrize("policy", ["auto", "kernel"])
def test_sort_batched_matches_reference(policy):
    """Two requests on the (2, 4) grid, the port's stage-2 groups fused
    into one pipeline, against the reference's per-row loop; the port's
    kernel policy gives the same bits as the reference's default."""
    xs = random_keys(np.int32, (2, 8 * N_LOCAL), seed=5)
    got, want = sort_batched_both(xs, 8, {"kernel_policy": policy},
                                  algorithm="multistage", tag=False)
    assert_batched_outputs_equal(got, want)
    for b in range(2):
        np.testing.assert_array_equal(got.gather(b), np.sort(xs[b]))


def test_spill_matches_reference():
    """The spill channel in both stages: stage 2's exchange takes a valid
    count per (shard, request) row, one request at a time."""
    xs = np.stack([tdist.make_adversarial("REVERSE", 8 * N_LOCAL, seed=0),
                   tdist.make_adversarial("PRESORTED", 8 * N_LOCAL, seed=1)])
    got, want = sort_batched_both(xs, 8, algorithm="multistage", tag=False,
                                  on_overflow="spill")
    assert_batched_outputs_equal(got, want)
    for b in range(2):
        np.testing.assert_array_equal(got.gather(b), np.sort(xs[b]))


def test_argsort_matches_reference():
    x = tdist.make_distribution("SKEW2", 4099, seed=1)
    got, want = argsort_both(x, 4, algorithm="multistage")
    assert_bits_equal(got, want, "argsort")
    np.testing.assert_array_equal(got, np.argsort(x, kind="stable"))


def test_stage_shapes():
    for p in range(1, 17):
        assert tdriver.factor_stages(p) == rdriver.factor_stages(p)
    with pytest.raises(ValueError, match="stages"):
        tsort.SortSpec(shards=8, stages=(3, 3))


def test_along_folds_and_logs():
    """Shard s = outer*r2 + inner: the outer view groups the shards that
    share an inner index, the inner view those that share an outer one;
    fold and unfold are inverse and calls land in the parent's log."""
    r1, r2, batch = 2, 3, 2
    comm = Comm(r1 * r2)
    x = torch.arange(r1 * r2 * batch * 4).reshape(r1 * r2, batch, 4)
    for axis, size in (("outer", r1), ("inner", r2)):
        view = comm.along(axis, r1, r2)
        folded = view.fold(x)
        assert folded.shape == (size, (r1 * r2 // size) * batch, 4)
        assert torch.equal(view.unfold(folded), x)
        total = view.psum(folded).reshape(-1, batch, 4)
        grid = x.reshape(r1, r2, batch, 4)
        want = grid.sum(0) if axis == "outer" else grid.sum(1)
        assert torch.equal(total, want)
        assert torch.equal(view.rows(torch.arange(batch)),
                           torch.arange(batch).repeat(r1 * r2 // size))
    assert dict(comm.log) == {"psum": 2}
    assert dict(comm.axis_log) == {("outer", "psum"): 1,
                                   ("inner", "psum"): 1}
    with pytest.raises(ValueError):
        comm.along("outer", 4, 4)


def _general_reference(rows, n_valid, p, num_parts, cfg, seed):
    """The reference's hss_splitters_general in shard_map over p shards:
    rows (p, n_local), a traced n_valid, the shards' fold_in keys."""
    def body(block, key, nv):
        me = jax.lax.axis_index("sort")
        keys, ranks, _ = rms.hss_splitters_general(
            block.reshape(-1), axis_names="sort", num_shards=p,
            num_parts=num_parts, cfg=cfg, rng=jr.fold_in(key, me),
            n_valid=nv)
        return keys, ranks

    f = jax.jit(shard_map(body, mesh=auto_mesh(p),
                          in_specs=(P("sort"), P(), P()),
                          out_specs=(P(), P())))
    return f(jnp.asarray(rows), jr.key(seed), jnp.int32(n_valid))


@pytest.mark.parametrize("p,num_parts", [(4, 2), (4, 4), (8, 3)])
def test_hss_splitters_general_matches_reference(p, num_parts):
    """Rows with a sentinel-padded tail and a traced n below p*n_local;
    every round runs, three psums and one all_gather each."""
    n_local, pad = 512, 40
    rng = np.random.default_rng(p + num_parts)
    rows = np.sort(rng.integers(-2 ** 31, 2 ** 31 - 1, (p, n_local)),
                   axis=1).astype(np.int32)
    rows[:, n_local - pad:] = np.iinfo(np.int32).max
    n_valid = p * (n_local - pad)
    cfg = rcommon.HSSConfig()
    want = _general_reference(rows, n_valid, p, num_parts, cfg, seed=3)

    keys = [jr.fold_in(jr.key(3), s) for s in range(p)]
    k = cfg.resolved_rounds(num_parts)
    draws = []
    for _ in range(k):
        row = []
        for s in range(p):
            keys[s], sub = jr.split(keys[s])
            row.append(np.asarray(jr.uniform(sub, (n_local,))))
        draws.append(torch.from_numpy(np.stack(row)))
    comm = Comm(p)
    got = tms.hss_splitters_general(
        torch.from_numpy(rows)[:, None], comm=comm, num_parts=num_parts,
        cfg=TorchHSSConfig(), uniform=lambda j: draws[j],
        n_valid=torch.tensor([n_valid], dtype=torch.int32))
    assert_bits_equal(got[0][0], want[0], "keys")
    assert_bits_equal(got[1][0], want[1], "ranks")
    assert dict(comm.log) == {"all_gather": k, "psum": 3 * k}


@pytest.mark.parametrize("exchange", ["dense", "allgather"])
def test_collectives_match_the_reference(exchange):
    """At one round a stage, the pipeline's calls are the reference's
    static totals: MULTISTAGE_BASE_COLLECTIVES plus one exchange a stage;
    the stage-1 exchange runs along outer, the stage-2 one along inner."""
    p, r1, r2 = 8, 2, 4
    local = torch.from_numpy(random_keys(np.int32, (p, 2, 256), seed=1))
    gen = torch.Generator().manual_seed(0)
    comm = Comm(p)
    tms.two_stage_sort_batched(
        local, comm=comm, r1=r1, r2=r2,
        uniform=lambda j, n: torch.rand((p, n), generator=gen),
        hss_cfg=TorchHSSConfig(rounds=1),
        ex_cfg=tex.ExchangeConfig(strategy=exchange))
    want = dict(rparts.MULTISTAGE_BASE_COLLECTIVES)
    for name, count in rex.EXCHANGE_COLLECTIVES[exchange].items():
        want[name] = want.get(name, 0) + 2 * count
    assert dict(comm.log) == {k: v for k, v in want.items() if v}
    ex = rex.EXCHANGE_COLLECTIVES[exchange]
    by_axis = {"sort": {"all_gather": 1, "psum": 3}, "outer": dict(ex),
               "inner": {k: ex.get(k, 0) + {"all_gather": 1,
                                            "psum": 4}.get(k, 0)
                         for k in ex}}
    for axis, calls in by_axis.items():
        assert {k: comm.axis_log[(axis, k)] for k in calls} == calls


def _reverse_case():
    return np.arange(8 * N_LOCAL, dtype=np.int32)[::-1].copy()


def test_overflow_counts_every_group():
    """Descending keys through pair caps too small: every group drops
    keys. The shards and counts are the reference's; its overflow is one
    shard's reading (the first group's), the port's every group's, which
    is the number of keys missing from the gather."""
    x = _reverse_case()
    got, want = sort_both(x, 8, algorithm="multistage", pair_factor=1.0,
                          tag=False)
    assert_bits_equal(got.shards, want.shards, "shards")
    assert_bits_equal(got.counts, want.counts, "counts")
    dropped = x.shape[0] - got.gather().shape[0]
    assert int(got.overflow) == dropped
    assert 0 < int(want.overflow) < dropped


def test_retry_ends_exact():
    """The retry policy escalates until no group drops a key."""
    x = _reverse_case()
    out = tsort.sort(x, tsort.SortSpec(shards=8, device="cpu",
                                       algorithm="multistage",
                                       pair_factor=1.0, tag=False,
                                       on_overflow="retry"))
    assert out.recovery.attempts > 1
    assert int(out.overflow) == 0
    np.testing.assert_array_equal(out.gather(), np.sort(x))


def test_stage2_draws_are_per_row():
    """Stage 2's draws are laid out like its rows: row (inner, outer*B +
    b) takes shard outer*r2 + inner's draw."""
    r1, r2, batch = 2, 3, 2
    p = r1 * r2
    u = torch.arange(p, dtype=torch.float32)[:, None].expand(p, 5)
    view = Comm(p).along("inner", r1, r2)
    rows = view.fold(u[:, None].expand(p, batch, 5))
    for i in range(r2):
        for o in range(r1):
            for b in range(batch):
                assert torch.all(rows[i, o * batch + b] == o * r2 + i)


@pytest.mark.parametrize("stages,n_local,seed", [
    ((8, 8), 256, 1), ((8, 8), 256, 2), ((4, 4), 1024, 3)])
def test_plain_two_stage_reference_holds_the_port(stages, n_local, seed):
    """Seeded UNIF keys through the front door on the (r1, r2) grid: the
    answer is the sorted input, each group within (1 + eps) N / r1, each
    shard within (1 + eps) G / r2 of its group and (1 + eps)^2 N / p."""
    r1, r2 = stages
    x = tdist.make_distribution("UNIF", r1 * r2 * n_local, seed=seed)
    spec = tsort.SortSpec(shards=r1 * r2, stages=stages, device="cpu",
                          algorithm="multistage", tag=False)
    out = tsort.sort(x, spec)
    checks = stage_checks(torch.as_tensor(x), out.shards, out.counts, r1,
                          r2, spec.eps)
    assert all(c["ok"] for c in checks.values()), checks
    assert checks["wrong_keys"]["value"] == 0
    assert checks["shard_excess"]["limit"] < (1 + spec.eps) ** 2 - 1 + 0.01
