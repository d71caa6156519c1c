"""K7 (`dense_send`), the dense exchange's send buffer, slice by slice,
and the exchanges that run it against the reference.

K7's wrapper (its plain version on the CPU), the "kernel" route and the
"torch" route (the plain version's int64 index gather) must each give a
buffer built run by run in Python, for every slice: empty, exactly `cap`
keys, cut at `cap`; rows with hi-sentinel pads past n_valid (a scalar, a
(B,) vector or a (p, B) count) and keys equal to the hi sentinel. Whole
dense and dense_spill exchanges on the card's routes equal the "torch"
policy's, make the same collective calls, and equal the reference's
exchange in shard_map bit for bit.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dense_send.py
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.parallel.compat import shard_map
from repro_torch.core import exchange as tex
from repro_torch.core.common import hi_sentinel
from repro_torch.kernels import dispatch
from repro_torch.kernels.send import kernel as tsend
from repro_torch.parallel.comm import Comm, recording
from torch_parity import (  # noqa: F401 (auto_on_card, a fixture)
    assert_bits_equal, assert_counters_equal, auto_mesh, auto_on_card,
    port_exchange_config)

# repro.core re-exports a function named `exchange`, which shadows the
# submodule as a package attribute
rex = importlib.import_module("repro.core.exchange")

DTYPES = {"int32": torch.int32, "int64": torch.int64}


@pytest.fixture
def rng():
    return np.random.default_rng(33)


def sorted_rows(rng, shape, dtype, pads=None):
    """Sorted rows of keys with duplicates; `pads` (broadcasting against
    the rows' leading axes) hi-sentinel slots at each row's tail."""
    wide = dtype == torch.int64
    span = 2 ** (62 if wide else 30)
    pool = rng.integers(-span, span, max(shape[-1] // 2, 1))
    x = torch.from_numpy(pool[rng.integers(0, pool.size, shape)]).to(dtype)
    if pads is not None:
        n = shape[-1]
        tail = torch.arange(n) >= n - torch.as_tensor(pads)[..., None]
        x = torch.where(tail, hi_sentinel(dtype), x)
    return torch.sort(x, dim=-1).values


def splitters(rng, rows):
    """(B, p-1) sorted splitters drawn from each request's keys."""
    p, batch, n = rows.shape
    keys = rows.transpose(0, 1).reshape(batch, -1)
    pick = torch.from_numpy(rng.integers(0, keys.shape[1], (batch, p - 1)))
    return torch.sort(torch.gather(keys, 1, pick), dim=-1).values


def slot_runs(rows, starts, sent, cap):
    """The send buffer (p_src, p_dst, B, cap) written run by run: slice
    (s, b, d)'s first sent keys, then the hi sentinel."""
    p, batch, _ = rows.shape
    buf = torch.full((p, p, batch, cap), hi_sentinel(rows.dtype),
                     dtype=rows.dtype)
    for s in range(p):
        for b in range(batch):
            for d in range(p):
                a, c = int(starts[s, b, d]), int(sent[s, b, d])
                buf[s, d, b, :c] = rows[s, b, a:a + c]
    return buf


def every_route(rows, starts, sent, cap):
    """The send buffer, after checking that K7's wrapper and the "kernel"
    and "torch" routes each write it as `slot_runs` does."""
    want = slot_runs(rows, starts, sent, cap)
    assert torch.equal(tsend.dense_send(rows, starts, sent, cap), want)
    for policy in ("kernel", "torch"):
        assert torch.equal(dispatch.dense_send(rows, starts, sent, cap,
                                               policy=policy), want)
    return want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("p", [2, 3, 8])
def test_every_route_copies_each_slice(rng, p, batch, dtype):
    """Slices cut by drawn splitters, at a cap that cuts the longer ones,
    at the exchange's own pair cap and at one past the row."""
    n = 203
    rows = sorted_rows(rng, (p, batch, n), DTYPES[dtype])
    starts, counts = tex.destination_slices(rows, splitters(rng, rows))
    pair = tex.ExchangeConfig().pair_cap(n, p)
    for cap in (max(1, n // (2 * p)), pair, n + 1):
        sent = torch.clamp(counts, max=cap)
        buf = every_route(rows, starts, sent, cap)
        for s, b, d in ((0, 0, 0), (p - 1, batch - 1, p - 1)):
            c, a = int(sent[s, b, d]), int(starts[s, b, d])
            assert torch.equal(buf[s, d, b, :c], rows[s, b, a:a + c])
            assert bool((buf[s, d, b, c:] == hi_sentinel(rows.dtype)).all())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_empty_full_and_cut_slices(rng, dtype):
    """Slices of no key, of exactly cap keys and of more (the count cut
    at cap), one of each in every row, and a row's last slice ending at
    its last key."""
    p, batch, n, cap = 3, 2, 40, 8
    rows = sorted_rows(rng, (p, batch, n), DTYPES[dtype])
    starts = torch.tensor([0, 0, 8], dtype=torch.int32).expand(p, batch, p)
    ends = torch.tensor([0, 8, n], dtype=torch.int32).expand(p, batch, p)
    sent = torch.clamp(ends - starts, max=cap)
    assert sent[0, 0].tolist() == [0, 8, 8]
    buf = every_route(rows, starts.contiguous(), sent.contiguous(), cap)
    hi = hi_sentinel(rows.dtype)
    assert bool((buf[:, 0] == hi).all())
    assert torch.equal(buf[:, 1], rows[..., :8])
    assert torch.equal(buf[:, 2], rows[..., 8:16])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_valid", ["scalar", "per_request", "per_row"])
def test_sentinel_padded_rows(rng, dtype, n_valid):
    """Rows with hi-sentinel pads past n_valid: destination_slices keeps
    the pads out of the last slice; every route sends the same bits."""
    p, batch, n = 4, 3, 150
    valid = {"scalar": torch.tensor(n - 17),
             "per_request": torch.tensor([n, n - 9, 1], dtype=torch.int32),
             "per_row": torch.from_numpy(
                 rng.integers(0, n + 1, (p, batch))).to(torch.int32)}[n_valid]
    nv = valid.expand(p, batch)
    rows = sorted_rows(rng, (p, batch, n), DTYPES[dtype], pads=n - nv)
    starts, counts = tex.destination_slices(rows, splitters(rng, rows), nv)
    assert int(counts.sum(-1).max()) <= n
    assert torch.equal(counts.sum(-1, dtype=torch.int32), nv.to(torch.int32))
    for cap in (8, 64, n):
        every_route(rows, starts, torch.clamp(counts, max=cap), cap)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_keys_equal_to_the_sentinel(rng, dtype):
    """Keys equal to the hi sentinel sent as keys: a slice that ends in
    them and a row of nothing else, counted in full."""
    p, batch, n = 2, 1, 32
    hi = hi_sentinel(DTYPES[dtype])
    rows = sorted_rows(rng, (p, batch, n), DTYPES[dtype], pads=[[5], [n]])
    starts = torch.tensor([[[0, 10]], [[0, 16]]], dtype=torch.int32)
    sent = torch.tensor([[[10, 22]], [[16, 16]]], dtype=torch.int32)
    buf = every_route(rows, starts, sent, n)
    assert bool((buf[1] == hi).all())
    assert torch.equal(buf[0, 1, 0, :22], rows[0, 0, 10:])


def test_wrapper_validates_arguments(rng):
    rows = sorted_rows(rng, (2, 1, 16), torch.int32)
    starts = torch.zeros((2, 1, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 or int64"):
        tsend.dense_send(rows.to(torch.int16), starts, starts, 4)
    with pytest.raises(TypeError, match="starts"):
        tsend.dense_send(rows, starts.long(), starts, 4)
    with pytest.raises(TypeError, match="counts"):
        tsend.dense_send(rows, starts, starts[:, :, :1], 4)
    with pytest.raises(ValueError, match="shards, batch, n"):
        tsend.dense_send(rows[0], starts, starts, 4)
    with pytest.raises(ValueError, match="cap"):
        tsend.dense_send(rows, starts, starts, -1)
    assert tsend.dense_send(rows, starts, starts, 0).shape == (2, 2, 1, 0)


def _exchange(rows, spl, strategy, policy, n_valid=None):
    """One batched exchange under `policy` and the collective calls it
    made, in order."""
    p = rows.shape[0]
    cfg = tex.ExchangeConfig(strategy=strategy, kernel_policy=policy)
    with recording() as events:
        out = tex.exchange_batched(rows, spl, comm=Comm(p), cfg=cfg,
                                   n_valid=n_valid)
    calls = [e.record for e in events if e.kind == "call"]
    return out, calls


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("strategy,batch", [("dense", 1), ("dense", 3),
                                            ("dense_spill", 1),
                                            ("dense_spill", 2)])
def test_exchanges_and_their_collectives_are_unchanged(
        rng, monkeypatch, dtype, strategy, batch):
    """A dense and a dense_spill exchange on the card's routes (K7's and
    K5's plain versions) give the "torch" policy's shards, counts and
    overflow, through the same collective calls, whose counts are the
    contract's. Request 0's splitters send every key to the last shard:
    past the pair capacity (dropped or spilled) and past out_cap."""
    p, n = 4, 96
    rows = sorted_rows(rng, (p, batch, n), DTYPES[dtype], pads=[[3]] * p)
    spl = splitters(rng, rows)
    spl[0] = rows[0, 0, 0]
    nv = torch.tensor(n - 3)
    want, want_calls = _exchange(rows, spl, strategy, "torch", nv)
    resolve = dispatch.resolve_policy
    monkeypatch.setattr(dispatch, "resolve_policy",
                        lambda policy, device: resolve(policy, "cuda"))
    got, calls = _exchange(rows, spl, strategy, "auto", nv)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert calls == want_calls
    contract = tex.EXCHANGE_COLLECTIVES[strategy]
    per_request = 1 if strategy in tex.BATCH_FUSED_STRATEGIES else batch
    for collective, count in contract.items():
        got_count = sum(r.collective == collective for r in calls)
        assert got_count == count * per_request, collective
    out_cap = tex.ExchangeConfig().out_cap(n, p, 0.05)
    assert int(got[1][-1, 0]) == out_cap
    # dense drops past the pair capacity; dense_spill only past out_cap
    kept = int(got[1][:, 0].sum()) + int(got[2][0])
    assert kept == (n - 3) * p


@pytest.mark.parametrize("policy,calls", [("auto", 0), ("torch", 0),
                                          ("kernel", 1)])
def test_policies_route_the_send(rng, monkeypatch, policy, calls):
    """On a CPU tensor "auto" and "torch" take the index gather and
    "kernel" calls K7's wrapper (its plain version) once an exchange."""
    real = tsend.dense_send
    seen = []
    monkeypatch.setattr(tsend, "dense_send",
                        lambda *a: seen.append(a) or real(*a))
    rows = sorted_rows(rng, (2, 1, 32), torch.int32)
    spl = splitters(rng, rows)
    out, _ = _exchange(rows, spl, "dense", policy)
    assert len(seen) == calls
    want, _ = _exchange(rows, spl, "dense", "torch")
    for g, w in zip(out, want):
        assert torch.equal(g, w)


def _ref_exchange(rows, keys, n_valid, cfg, eps):
    """The reference's batched exchange of (p, B, n) rows in shard_map
    over an Auto mesh of p host devices."""
    p = rows.shape[0]

    def body(local, k, nv):
        out, n_out, ovf = rex.exchange_batched(
            local[0], k, axis_name="sort", p=p, cfg=cfg, eps=eps,
            n_valid=nv)
        return out[None], n_out[None], ovf

    fn = jax.jit(shard_map(body, mesh=auto_mesh(p),
                           in_specs=(P("sort"), P(), P()),
                           out_specs=(P("sort"), P("sort"), P())))
    return fn(jnp.asarray(rows), jnp.asarray(keys), jnp.asarray(n_valid))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("strategy", ["dense", "dense_spill"])
def test_card_route_exchanges_match_reference(monkeypatch, auto_on_card,
                                              strategy, dtype):
    """A dense and a dense_spill exchange with "auto" resolved as on the
    card, so the send is K7's (its plain version here), once a request
    for dense_spill and once a batch for dense: shards, counts and
    overflow equal the reference's bit for bit (int64 keys under x64).
    Request 0 is balanced; request 1 sends every key to shard 0, past
    the pair capacity (dropped or spilled) and out_cap. The last 13
    slots of every row are hi-sentinel pads past n_valid."""
    p, batch, n = 4, 2, 256
    rng = np.random.default_rng(p)
    wide = dtype == "int64"
    np_dtype = np.int64 if wide else np.int32
    span = 2 ** 40 if wide else 10 ** 6
    rows = np.sort(rng.integers(0, span, (p, batch, n)), axis=-1)
    keys = np.stack([np.quantile(rows[:, b], np.linspace(0, 1, p + 1)[1:-1])
                     for b in range(batch)])
    keys[1] = span + np.arange(p - 1)                # all to shard 0
    rows[:, :, -13:] = np.iinfo(np_dtype).max
    rows, keys = rows.astype(np_dtype), keys.astype(np_dtype)
    n_valid = np.full((batch,), n - 13, np.int32)
    cfg, eps = rex.ExchangeConfig(strategy=strategy), 0.05
    with jax.enable_x64(wide):
        want = _ref_exchange(rows, keys, n_valid, cfg, eps)
        want = [np.asarray(w) for w in want]
    real, sends = tsend.dense_send, []
    monkeypatch.setattr(tsend, "dense_send",
                        lambda *a: sends.append(a) or real(*a))
    got = tex.exchange_batched(
        torch.from_numpy(rows), torch.from_numpy(keys), comm=Comm(p),
        cfg=port_exchange_config(cfg), eps=eps,
        n_valid=torch.from_numpy(n_valid))
    assert len(sends) == (batch if strategy == "dense_spill" else 1)
    assert_bits_equal(got[0], want[0], "out")
    assert_counters_equal(got[1], want[1], "n_valid", x64=wide)
    assert_counters_equal(got[2], want[2], "overflow", x64=wide)
    assert int(got[2][1]) > 0 and int(got[2][0]) == 0
