"""The post-exchange merge (K5's plain version and its dispatch) against
`torch.sort` of each row followed by `cap_to`, and the exchanges bit for
bit between the kernel and torch policies.

K5 (`merge_path_pairs`) has no CPU mode: on a CPU tensor its wrapper runs
`merge_path_pairs_plain`, the same merge-path arithmetic in torch ops, so
these tests hold the route that the card takes for rows of every length.
Each run's slots past its count hold the hi sentinel, as every caller
leaves them. Inputs are made from a seed with numpy; the tolerance is
zero. The card's own check is `tests/test_torch_cuda.py`.

    PYTHONPATH=src python -m pytest -q tests/test_torch_merge_path.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import exchange as tex
from repro_torch.kernels import dispatch
from repro_torch.kernels.merge import kernel as tmk
from repro_torch.kernels.merge import ops as tmops
from repro_torch.parallel.comm import Comm

INT_MAX = np.iinfo(np.int32).max
KS = [1, 2, 3, 5, 8, 16]
KINDS = ["random", "equal", "sentinel", "empty"]
OUT_LENS = ["none", "below", "at", "above"]


def _runs(rng, lead, k, r, kind):
    """Sorted (*lead, k, r) runs whose slots past their counts hold the
    hi sentinel, and the counts: random keys; all keys equal; hi
    sentinels among the keys; a third of the runs empty (a whole row of
    them in the first row)."""
    shape = (*lead, k, r)
    if kind == "equal":
        x = np.full(shape, 7, np.int64)
    else:
        x = rng.integers(-2 ** 31, INT_MAX, size=shape, dtype=np.int64)
    if kind == "sentinel":
        x[rng.random(shape) < 0.2] = INT_MAX
    counts = rng.integers(0, r + 1, size=(*lead, k))
    if kind == "empty":
        counts[rng.random(counts.shape) < 1 / 3] = 0
        counts.reshape(-1, k)[0] = 0
    x = np.sort(x, axis=-1)
    x = np.where(np.arange(r) < counts[..., None], x, INT_MAX)
    return (torch.from_numpy(x.astype(np.int32)),
            torch.from_numpy(counts.astype(np.int32)))


def _out_len(which, counts, k, r):
    totals = counts.reshape(-1, k).sum(-1)
    return {"none": None, "below": max(1, int(totals.min()) - 3),
            "at": int(totals.max()), "above": k * r + 9}[which]


def _want(x, out_len):
    rows = torch.sort(x.reshape(x.shape[:-2] + (-1,)), dim=-1).values
    return rows if out_len is None else tmops.cap_to(rows, out_len)


@pytest.mark.parametrize("out_len", OUT_LENS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_merge_runs_with_counts_equals_sort_then_cap(rng, k, kind, out_len):
    """Rows of about 20,000 keys, leading axes (p, B) = (2, 3)."""
    r = 20_011 // k + 1                     # not a power of two
    x, counts = _runs(rng, (2, 3), k, r, kind)
    length = _out_len(out_len, counts, k, r)
    got = dispatch.merge_runs(x, policy="kernel", counts=counts,
                              out_len=length)
    want = _want(x, length)
    assert torch.equal(got, want)
    assert torch.equal(dispatch.merge_runs(x, policy="torch", counts=counts,
                                           out_len=length), want)


@pytest.mark.parametrize("out_len", OUT_LENS)
@pytest.mark.parametrize("k,r", [(3, 37), (8, 100), (16, 1000)])
def test_merge_runs_of_short_rows_equals_sort_then_cap(rng, k, r, out_len):
    """Rows of 111 to 16,000 keys (the service's small requests), with and
    without counts."""
    x, counts = _runs(rng, (2,), k, r, "random")
    length = _out_len(out_len, counts, k, r)
    assert torch.equal(dispatch.merge_runs(x, policy="kernel",
                                           out_len=length), _want(x, length))
    got = dispatch.merge_runs(x, policy="kernel", counts=counts,
                              out_len=length)
    assert torch.equal(got, _want(x, length))


@pytest.mark.parametrize("counts_given", [True, False])
@pytest.mark.parametrize("k", KS)
def test_merge_path_pairs_plain_merges_each_pair(rng, k, counts_given):
    """One level: output run j is runs 2j and 2j+1 merged (an odd last
    run alone), its count their sum; past it the sentinel. With out_len,
    each output run is cut or padded to it."""
    r = 301
    x, counts = _runs(rng, (4,), k, r, "random")
    c = counts if counts_given else None
    out, merged = tmk.merge_path_pairs(x, c)
    full = counts if counts_given else torch.full_like(counts, r)
    assert out.shape == (4, (k + 1) // 2, 2 * r)
    for j in range((k + 1) // 2):
        pair = x[:, 2 * j:2 * j + 2]
        assert torch.equal(merged[:, j], full[:, 2 * j:2 * j + 2].sum(-1)
                           .to(torch.int32))
        assert torch.equal(out[:, j], _want(pair[:, None], 2 * r)[:, 0])
    cut, cut_counts = tmk.merge_path_pairs(x, c, out_len=r // 2)
    assert torch.equal(cut, out[..., :r // 2])
    assert torch.equal(cut_counts, merged.clamp(max=r // 2))


def test_merge_path_pairs_clamps_counts_to_the_stride(rng):
    x, counts = _runs(rng, (3,), 4, 50, "random")
    over = counts.clone()
    over[:, 1] = 80
    over[:, 2] = -4
    full = counts.clone()
    full[:, 1] = 50
    full[:, 2] = 0
    x[:, 2] = INT_MAX
    assert torch.equal(tmk.merge_path_pairs(x, over)[0],
                       tmk.merge_path_pairs(x, full)[0])


def test_merge_path_pairs_validates_arguments():
    x = torch.zeros((2, 3, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        tmk.merge_path_pairs(x.to(torch.int16))   # int32 and int64 only
    with pytest.raises(ValueError):
        tmk.merge_path_pairs(x[0])
    with pytest.raises(ValueError):
        tmk.merge_path_pairs(x, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        tmk.merge_path_pairs(x, out_len=0)


# ---------------------------------------------------------- the exchanges
P, N = 4, 8_192      # rows of 4-8 runs of 4,096-8,192 slots: K5 levels


def _shards(kind, batch):
    """(p, B, n) locally sorted shards and (B, p-1) splitters at the
    keys' quantiles. "skewed": shard s holds the s-th quarter of the key
    range, so each source sends all its keys to one destination, past the
    dense pair capacity."""
    rng = np.random.default_rng(7)
    keys = rng.integers(-2 ** 31, INT_MAX, size=(P, batch, N), dtype=np.int64)
    keys[:, 0, :50] = 3                      # duplicates across shards
    if kind == "skewed":
        keys = np.sort(keys.transpose(1, 0, 2).reshape(batch, -1), axis=-1
                       ).reshape(batch, P, N).transpose(1, 0, 2)
    spl = np.quantile(keys.transpose(1, 0, 2).reshape(batch, -1),
                      np.arange(1, P) / P, axis=-1).T
    return (torch.from_numpy(np.sort(keys, axis=-1).astype(np.int32)),
            torch.from_numpy(spl.astype(np.int32)).contiguous())


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
@pytest.mark.parametrize("strategy", ["dense", "dense_spill", "allgather",
                                      "ragged"])
def test_exchange_kernel_policy_equals_torch_policy(strategy, kind, batch):
    shards, splitters = _shards(kind, batch)
    outs = {}
    for policy in ("kernel", "torch"):
        cfg = tex.ExchangeConfig(strategy=strategy, kernel_policy=policy)
        outs[policy] = tex.exchange_batched(shards, splitters, comm=Comm(P),
                                            cfg=cfg, eps=0.05)
    for got, want in zip(outs["kernel"], outs["torch"]):
        assert torch.equal(got, want)
    out, _, overflow = outs["kernel"]
    # only the dense channel drops keys: the skewed shards overflow it
    dropped = strategy == "dense" and kind == "skewed"
    assert bool((overflow > 0).all()) == dropped
    assert bool((out[..., :-1] <= out[..., 1:]).all())
