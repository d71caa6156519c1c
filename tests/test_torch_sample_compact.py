"""K6 (`sample_compact`), the splitter round's sample, against the masked
sort it replaces, bit for bit.

The torch route of `dispatch.sample_compact` is the reference's round
(repro/core/splitters.py:168: membership of every key, the Bernoulli mask,
a full sort of each masked row). K6's plain version, and `_sample_round`
under "kernel", must give its bits: the sample buffer, the sample count
and the overflow. The states come from `refine` over probes drawn from the
rows themselves (so interval ends equal keys of the rows), with none, some
or all splitters satisfied, or the first round's sentinels. The rows hold
duplicates and hi-sentinel pads. Whole splitter searches (the batched
engine and multistage's per-row state) under "kernel" equal the "torch"
policy's keys, ranks and SplitterStats. No jax: the file also runs on the
card, where tests/test_torch_cuda.py holds the kernel to the plain version.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sample_compact.py
"""
import dataclasses

import pytest
import torch

from repro_torch.core import multistage as tms
from repro_torch.core import splitters as tsp
from repro_torch.core.common import HSSConfig, hi_sentinel
from repro_torch.kernels import dispatch
from repro_torch.kernels.sample import kernel as tsk
from repro_torch.parallel.comm import Comm
from torch_parity import auto_on_card  # noqa: F401

P = 4
DTYPES = {"int32": torch.int32, "int64": torch.int64}


def sorted_rows(rng, shape, dtype, distinct=None):
    """Sorted rows of keys with duplicates (`distinct` values, spread over
    the dtype's range) and a hi-sentinel tail of random length a row."""
    hi = hi_sentinel(dtype)
    wide = dtype == torch.int64
    pool = rng.integers(-2 ** (62 if wide else 30), 2 ** (62 if wide else 30),
                        distinct or shape[-1] * 4)
    x = torch.from_numpy(pool[rng.integers(0, pool.size, shape)]).to(dtype)
    pads = torch.from_numpy(rng.integers(0, shape[-1] // 8 + 1,
                                         shape[:-1]))
    x = torch.where(torch.arange(shape[-1]) >= shape[-1] - pads[..., None],
                    hi, x)
    return torch.sort(x, dim=-1).values


def make_state(rng, rows, case):
    """(B, p-1) states for the (p, B, n) rows: "first" is the first round's
    (sentinels, nothing satisfied); the others refine with 12 probes drawn
    from request b's keys and their exact ranks, then mark none, some or
    all of the splitters satisfied."""
    p, batch, n = rows.shape
    state = tsp.init_state(p, p * n, rows.dtype, batch=(batch,))
    if case == "first":
        return state
    keys = rows.transpose(0, 1).reshape(batch, -1)
    pick = torch.from_numpy(rng.integers(0, keys.shape[1], (batch, 12)))
    probes = torch.sort(torch.gather(keys, 1, pick), dim=-1).values
    ranks = torch.searchsorted(torch.sort(keys, dim=-1).values.contiguous(),
                               probes).to(torch.int32)
    state = tsp.refine(state, probes, ranks,
                       tsp.splitter_targets(p * n, p), tol=1)
    sat = {"none": torch.zeros_like(state.satisfied),
           "some": torch.arange(p - 1).expand(batch, p - 1) % 2 == 1,
           "all": torch.ones_like(state.satisfied)}[case]
    return state._replace(satisfied=sat)


def draws(rng, rows, shared, dtype):
    p, batch, n = rows.shape
    shape = (p, n) if shared else (p, batch, n)
    return torch.from_numpy(rng.random(shape)).to(dtype)


def probs(rng, batch, case):
    if case == "one":
        return torch.ones(batch, dtype=torch.float32)
    scale = 0.5 if case == "half" else 0.02
    return torch.from_numpy(scale * rng.random(batch) + 1e-3
                            ).to(torch.float32)


def torch_route(rows, state, u, prob, cap):
    return dispatch.sample_compact(rows, state.lo_key, state.hi_key,
                                   state.satisfied, u, prob, cap,
                                   policy="torch")


def assert_same(got, want):
    for g, w, name in zip(got, want, ("vals", "sampled", "overflow")):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("prob_case", ["half", "small", "one"])
@pytest.mark.parametrize("state_case", ["first", "none", "some", "all"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.float64],
                         ids=["u32", "u64"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_and_kernel_route_equal_the_masked_sort(
        rng, dtype, shared, u_dtype, batch, state_case, prob_case):
    """K6's plain version and `_sample_round` under "kernel" against the
    torch route, at a cap that overflows and at one past the row length;
    n = 999 leaves a partial last vector of four draws."""
    rows = sorted_rows(rng, (P, batch, 999), DTYPES[dtype], distinct=300)
    state = make_state(rng, rows, state_case)
    u = draws(rng, rows, shared, u_dtype)
    prob = probs(rng, batch, prob_case)
    for cap in (8, 1200):
        want = torch_route(rows, state, u, prob, cap)
        assert want[0].shape[-1] == min(cap, 999)
        assert_same(tsk.sample_compact(rows, state.lo_key, state.hi_key,
                                       state.satisfied, u, prob, cap), want)
        assert_same(tsp._sample_round(rows, state, prob, cap, u,
                                      kernel_policy="kernel"), want)
        if state_case == "all":
            assert int(want[1].sum()) == 0
        if cap == 8 and prob_case == "one" and state_case == "first":
            assert int(want[2].min()) > 0        # every row overflows


@pytest.mark.parametrize("n", [1, 5, 32, 8192, 8195, 20000])
def test_row_lengths_around_the_tile(rng, n):
    """Rows of one key, under a vector of four, one K6 tile, just past it
    and over two, with the state taken from the rows."""
    rows = sorted_rows(rng, (P, 2, n), torch.int32)
    for case in ("first", "none", "some"):
        state = make_state(rng, rows, case)
        u = draws(rng, rows, True, torch.float32)
        prob = torch.tensor([0.3, 1.0], dtype=torch.float32)
        want = torch_route(rows, state, u, prob, 64)
        assert_same(tsk.sample_compact(rows, state.lo_key, state.hi_key,
                                       state.satisfied, u, prob, 64), want)


def test_interval_ends_on_runs_of_equal_keys(rng):
    """lo_key and hi_key equal to keys that repeat: the range starts past
    lo_key's run (the right-side search) and ends at hi_key's."""
    rows = torch.sort(torch.from_numpy(rng.integers(0, 6, (P, 1, 64))
                                       ).to(torch.int32), dim=-1).values
    state = tsp.init_state(P, P * 64, torch.int32, batch=(1,))
    state = state._replace(
        lo_key=torch.tensor([[1, 2, 4]], dtype=torch.int32),
        hi_key=torch.tensor([[3, 4, 5]], dtype=torch.int32))
    u = torch.zeros((P, 64), dtype=torch.float32)
    prob = torch.ones(1, dtype=torch.float32)
    got = tsk.sample_compact(rows, state.lo_key, state.hi_key,
                             state.satisfied, u, prob, 64)
    assert_same(got, torch_route(rows, state, u, prob, 64))
    for s in range(P):          # (1, 3) keeps 2, (2, 4) keeps 3
        row = rows[s, 0]
        kept = row[(row == 2) | (row == 3)]
        assert torch.equal(got[0][s, 0, :kept.numel()], kept)
        assert int(got[1][s, 0]) == kept.numel()


def test_multistage_layout_per_row_state(rng):
    """Multistage's layout: (P, R, n) rows whose state is (R, p-1) per
    sort, with per-row draws and a probability a row."""
    rows = sorted_rows(rng, (4, 6, 500), torch.int64)
    state = make_state(rng, rows, "some")
    u = draws(rng, rows, False, torch.float32)
    prob = probs(rng, 6, "half")
    want = torch_route(rows, state, u, prob, 16)
    assert_same(tsp._sample_round(rows, state, prob, 16, u,
                                  kernel_policy="kernel"), want)


def test_wrapper_validates_arguments(rng):
    rows = sorted_rows(rng, (P, 1, 64), torch.int32)
    state = make_state(rng, rows, "first")
    u = draws(rng, rows, True, torch.float32)
    prob = torch.ones(1, dtype=torch.float32)
    args = (rows, state.lo_key, state.hi_key, state.satisfied, u, prob, 8)

    def call(**change):
        names = ("keys", "lo_key", "hi_key", "satisfied", "u", "prob",
                 "cap")
        kw = dict(zip(names, args))
        kw.update(change)
        return tsk.sample_compact(**kw)

    with pytest.raises(TypeError, match="int32 or int64"):
        call(keys=rows.to(torch.int16))
    with pytest.raises(TypeError, match="lo_key"):
        call(lo_key=state.lo_key.to(torch.int64))
    with pytest.raises(TypeError, match="float32 or float64"):
        call(u=u.to(torch.float16))
    with pytest.raises(ValueError, match="draws"):
        call(u=u[:, :10])
    with pytest.raises(TypeError, match="prob"):
        call(prob=prob.to(torch.float64))
    with pytest.raises(ValueError, match="cap"):
        call(cap=0)


def _batched(rows, policy, cfg):
    p, _, n = rows.shape
    gen = torch.Generator().manual_seed(7)
    u = [torch.rand((p, n), generator=gen)
         for _ in range(cfg.resolved_rounds(p))]
    return tsp.hss_splitters_batched(
        rows, comm=Comm(p), uniform=lambda j: u[j],
        cfg=dataclasses.replace(cfg, kernel_policy=policy))


@pytest.mark.parametrize("dtype,policy", [
    ("int32", "kernel"), ("int32", "auto"), ("int64", "auto")])
@pytest.mark.parametrize("cfg", [HSSConfig(), HSSConfig(eps=0.01),
                                 HSSConfig(sample_per_shard=8)],
                         ids=["default", "tight", "tiny_sample"])
def test_splitter_search_on_the_kernels_equals_torch(rng, request, cfg,
                                                     dtype, policy):
    """hss_splitters_batched over 3 requests, under "kernel" and under
    "auto" as it resolves on the card (the route of 64-bit keys, whose
    local sorts "kernel" refuses): the splitter keys, ranks and every
    SplitterStats field equal the "torch" policy's."""
    rows = sorted_rows(rng, (8, 3, 2048), DTYPES[dtype])
    want = _batched(rows, "torch", cfg)
    if policy == "auto":
        request.getfixturevalue("auto_on_card")
    got = _batched(rows, policy, cfg)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)


def test_multistage_splitters_under_kernel_equal_torch(rng):
    """hss_splitters_general (every round runs, per-row n over padded rows,
    per-row draws) under "kernel" and "torch"."""
    rows = sorted_rows(rng, (4, 3, 1024), torch.int32)
    n_valid = torch.tensor([4096, 4000, 3500], dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    u = [torch.rand((4, 3, 1024), generator=gen) for _ in range(8)]
    out = {}
    for policy in ("kernel", "torch"):
        out[policy] = tms.hss_splitters_general(
            rows, comm=Comm(4), num_parts=4,
            cfg=HSSConfig(kernel_policy=policy), uniform=lambda j: u[j],
            n_valid=n_valid)
    got, want = out["kernel"], out["torch"]
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)
