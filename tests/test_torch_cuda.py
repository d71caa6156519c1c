"""The port's CUDA kernels against their plain versions, on the card.

Each test is `cuda`-marked and skips where there is no CUDA device (the
kernels have no CPU mode). The file imports neither jax nor repro, so it
runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.bitonic_sort import kernel as tbk
from repro_torch.kernels.histogram import kernel as thk
from repro_torch.kernels.merge import kernel as tmk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


#: The merge cascade's HBM passes (K3 and K2's tail): only a local sort of
#: rows longer than one K2 segment (16,384 keys) launches them.
HBM_PASSES = ("strided_compare_exchange", "bitonic_merge_smem.tail")


def _assert_main_path_launches(rows_on_chip=False, dense=True):
    """Every kernel of the int32 main paths launched, but the HBM passes
    where each local sort's rows fit one K2 segment (`rows_on_chip`) and
    K7 where the exchange sends no dense buffer (`dense` False: allgather,
    ragged); the counting K4, which only `assume_sorted=False` reaches,
    and the int64 instantiations (`cuda.WIDE`) did not."""
    got = dict(cuda.launches)
    never = cuda.OFF_MAIN_PATH + cuda.WIDE + (() if dense
                                              else ("dense_send",))
    skip = never + (HBM_PASSES if rows_on_chip else ())
    assert all(got[k] > 0 for k in cuda.COUNTERS if k not in skip), got
    assert all(got[k] == 0 for k in never), got


def _card_keys(shape, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                         device="cuda", dtype=torch.int32)


BLOCKS = [1 << j for j in range(1, 11)]        # 2 .. MAX_BLOCK
SEGMENTS = [1 << j for j in range(1, 15)]      # 2 .. SMEM_MAX_SEG


def _edge_rows(rows, n, seed=0):
    """Random keys with the edge rows: all INT_MAX (the hi sentinel),
    duplicates, INT_MIN among INT_MAX and small keys."""
    i32 = torch.iinfo(torch.int32)
    x = _card_keys((rows, n), seed)
    x[1] = i32.max
    x[2] &= 7
    pick = _card_keys((n,), seed + 1) & 3
    x[3] = torch.where(pick == 0, i32.min,
                       torch.where(pick == 1, i32.max, x[3] & 15))
    return x


def _check_sort(x, block):
    before = cuda.launches["bitonic_sort_blocks"]
    got = tbk.sort_blocks(x, block)
    torch.cuda.synchronize()
    assert cuda.launches["bitonic_sort_blocks"] == before + 1
    assert torch.equal(got, tbk.sort_blocks_plain(x, block))


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS)
def test_cuda_bitonic_sort_blocks(card, block):
    """K1 at every block size, 8 rows with the edge rows."""
    _check_sort(_edge_rows(8, 1 << 16), block)


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS)
def test_cuda_bitonic_sort_blocks_offset_view(card, block):
    """K1 on a row that starts one key into its allocation (so not 16-byte
    aligned), 5 blocks long: at blocks below 32 the last warp's chunk is
    partial."""
    n = 5 * block
    x = _card_keys((n + 1,))[1:].view(1, n)
    _check_sort(x, block)


def _merge_rows(rows, n, seg, seed=0):
    """Sorted runs of seg/2 keys, with the edge rows (`_edge_rows`); the
    last row is left unsorted."""
    x = _edge_rows(rows, n, seed)
    x[:-1] = torch.sort(x[:-1].view(rows - 1, -1, seg // 2), dim=-1
                        ).values.view(rows - 1, n)
    return x


def _check_merge(x, seg, reverse):
    counter = ("bitonic_merge_smem.reverse" if reverse
               else "bitonic_merge_smem.tail")
    before = cuda.launches[counter]
    got = tbk.bitonic_merge_smem(x, seg, reverse)
    torch.cuda.synchronize()
    assert cuda.launches[counter] == before + 1
    assert torch.equal(got, tbk.bitonic_merge_plain(x, seg, reverse))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("seg", SEGMENTS)
def test_cuda_bitonic_merge_smem(card, seg, reverse):
    """K2 at every segment size, both roles, 5 rows with the edge rows."""
    _check_merge(_merge_rows(5, 1 << 15, seg), seg, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("d,flip", [(1, False), (2, True), (1 << 14, True),
                                    (1 << 15, False)])
def test_cuda_strided_compare_exchange(card, d, flip):
    x = _card_keys((4, 1 << 16))
    got = tmk.strided_compare_exchange(x, d, flip)
    assert torch.equal(got, tmk.strided_compare_exchange_plain(x, d, flip))


def _counted_runs(rows, k, stride, counts, seed=0):
    """(rows, k, stride) sorted runs from the edge rows (`_edge_rows`, one
    a run), the hi sentinel past each run's count."""
    x = _edge_rows(rows * k, stride, seed).view(rows, k, stride)
    x = torch.where(torch.arange(stride, device="cuda") < counts[..., None],
                    x, torch.iinfo(torch.int32).max)
    return torch.sort(x, dim=-1).values


def _check_merge_path(x, counts, out_len, fill):
    counter = ("merge_path_pairs.i64" if x.dtype == torch.int64
               else "merge_path_pairs")
    before = cuda.launches[counter]
    got, got_n = tmk.merge_path_pairs(x, counts, out_len, _fill=fill)
    torch.cuda.synchronize()
    assert cuda.launches[counter] == before + 1
    want, want_n = tmk.merge_path_pairs_plain(x, counts, out_len)
    assert torch.equal(got_n, want_n)
    if not fill:    # slots past a merged count are left unwritten
        past = torch.arange(got.shape[-1], device="cuda") >= got_n[..., None]
        got = torch.where(past, torch.iinfo(x.dtype).max, got)
    assert torch.equal(got, want)


def _wide_runs(rows, k, stride, counts, seed=0):
    """`_counted_runs` widened to int64 tag packs: each edge-row key
    shifted into the top bits over a 28-bit index (a 60-bit pack, the
    int32 sentinel's slots becoming INT64_MAX)."""
    x = _counted_runs(rows, k, stride, counts, seed)
    idx = torch.arange(x.numel(), device="cuda").view(x.shape) & (2 ** 28 - 1)
    wide = (x.long() << 28) | idx
    return torch.where(x == torch.iinfo(torch.int32).max,
                       torch.iinfo(torch.int64).max,
                       torch.sort(wide, dim=-1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [True, False])
@pytest.mark.parametrize("out_len", [None, 7_000, 18_335])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_cuda_merge_path_pairs_matches_plain(card, k, out_len, fill):
    """K5, one level, at a small ragged shape: 6 rows of k runs of 9,001
    slots with counts 0..9,001 (row 0's runs empty), the edge rows' keys,
    with and without counts; out_len cuts, or pads past 2 x 9,001. The
    public call fills each run's tail with the hi sentinel, as the plain
    version does; merge_sorted_runs' inner levels (`_fill=False`) match it
    on each merged count's prefix."""
    g = torch.Generator(device="cuda")
    g.manual_seed(k)
    counts = torch.randint(0, 9_002, (6, k), generator=g, device="cuda",
                           dtype=torch.int32)
    counts[0] = 0
    _check_merge_path(_counted_runs(6, k, 9_001, counts, seed=k), counts,
                      out_len, fill)
    _check_merge_path(_card_keys((6, k, 9_001), seed=k).sort(dim=-1).values,
                      None, out_len, fill)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [True, False])
@pytest.mark.parametrize("out_len", [None, 7_000, 18_335])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_cuda_merge_path_pairs_int64_matches_plain(card, k, out_len, fill):
    """K5's int64 instantiation, one level, at the int32 test's shapes on
    60-bit tag packs with INT64_MAX past each count (and among the keys,
    from the edge rows' INT_MAX)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(k)
    counts = torch.randint(0, 9_002, (6, k), generator=g, device="cuda",
                           dtype=torch.int32)
    counts[0] = 0
    _check_merge_path(_wide_runs(6, k, 9_001, counts, seed=k), counts,
                      out_len, fill)


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(2, 37), (3, 1_000), (8, 2_047),
                                 (16, 1_000)])
def test_cuda_merge_sorted_runs_of_short_rows(card, k, r):
    """Rows of 74 to 16,376 keys (the service's small requests): ceil(log2
    k) K5 launches, equal to torch.sort of each row cut or padded to
    out_len, with counts and without."""
    from repro_torch.kernels.merge import ops as mops

    g = torch.Generator(device="cuda")
    g.manual_seed(k)
    counts = torch.randint(0, r + 1, (5, k), generator=g, device="cuda",
                           dtype=torch.int32)
    x = _counted_runs(5, k, r, counts, seed=k)
    for c in (counts, None):
        for out_len in (None, k * r // 2, k * r + 9):
            before = cuda.launches["merge_path_pairs"]
            got = mops.merge_sorted_runs(x, counts=c, out_len=out_len)
            assert cuda.launches["merge_path_pairs"] == before + (
                (k - 1).bit_length())
            want = torch.sort(x.view(5, -1), dim=-1).values
            assert torch.equal(got, want if out_len is None
                               else mops.cap_to(want, out_len))


@pytest.mark.cuda
def test_cuda_merge_sorted_runs_at_the_benchmark_shape(card):
    """The benchmark's post-exchange merge (2^28 keys, p = 8): 8 rows of
    8 runs of 12,582,912 slots, each run 2^22 +- 4,096 keys. Three K5
    launches, equal to torch.sort of each row cut to out_cap and to the
    plain version's three levels."""
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.kernels.merge import ops as mops

    cfg = ExchangeConfig()
    cap, out_cap = cfg.pair_cap(1 << 25, 8), cfg.out_cap(1 << 25, 8, 0.05)
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    counts = (1 << 22) + torch.randint(-4096, 4097, (8, 8), generator=g,
                                       device="cuda", dtype=torch.int32)
    x = _counted_runs(8, 8, cap, counts, seed=5)
    before = cuda.launches["merge_path_pairs"]
    got = mops.merge_sorted_runs(x, counts=counts, out_len=out_cap)
    torch.cuda.synchronize()
    assert cuda.launches["merge_path_pairs"] == before + 3
    assert torch.equal(got, torch.sort(x.view(8, -1), dim=-1
                                       ).values[:, :out_cap])
    y, c = x, counts
    while y.shape[1] > 2:
        y, c = tmk.merge_path_pairs_plain(y, c)
    assert torch.equal(got, tmk.merge_path_pairs_plain(y, c, out_cap)[0][:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 22])
def test_cuda_local_sort_at_the_two_stage_shape(card, seed):
    """The two-stage cell's local sort (2^28 keys, p = 64): (64, 1, 2^22)
    rows, at `AUTO_SORT_MAX_N`, so "auto" sends them to K1-K3; equal to
    torch.sort bit for bit."""
    from repro_torch.kernels import dispatch

    n = dispatch.AUTO_SORT_MAX_N
    assert n == 1 << 22
    x = _card_keys((64, 1, n), seed)
    x[7] &= 255                                   # a row of duplicates
    before = dict(cuda.launches)
    got = dispatch.local_sort(x, policy="auto")
    torch.cuda.synchronize()
    ran = {k for k in ("bitonic_sort_blocks", "strided_compare_exchange",
                       "bitonic_merge_smem.reverse", "bitonic_merge_smem.tail")
           if cuda.launches[k] > before[k]}
    assert len(ran) == 4, ran
    assert torch.equal(got, torch.sort(x, dim=-1).values)


@pytest.mark.cuda
def test_cuda_probe_rank_count(card):
    keys = _card_keys((8, 100_003))
    probes = torch.sort(_card_keys((8, 256), seed=1), dim=-1).values
    got = thk.probe_rank_count(keys, probes)
    assert torch.equal(got, thk.probe_ranks_plain(keys, probes))


# ------------------------------------------------ batched row counts
@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS)
def test_cuda_bitonic_sort_blocks_batched_rows(card, block):
    """K1 as Pallas #2: 64 rows (B = 8 requests x p = 8 shards) with the
    edge rows, at every block size."""
    _check_sort(_edge_rows(64, 1 << 14), block)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("seg", SEGMENTS)
def test_cuda_merge_adjacent_batched_rows(card, seg, reverse):
    """K2 as Pallas #4 (reverse) and #8 (tail) over B*p-like rows: 65, an
    odd count, with the edge rows."""
    _check_merge(_merge_rows(65, 1 << 15, seg, seed=2), seg, reverse)


@pytest.mark.cuda
def test_cuda_merge_bitonic_blocks_batched_rows(card):
    """K2 with no reverse (Pallas #8, an HBM pass's tail) over 64 rows."""
    x = _card_keys((64, 1 << 15))
    before = cuda.launches["bitonic_merge_smem.tail"]
    got = tbk.bitonic_merge_smem(x, tbk.SMEM_MAX_SEG, False)
    assert torch.equal(got, tbk.bitonic_merge_plain(x, tbk.SMEM_MAX_SEG,
                                                    False))
    assert cuda.launches["bitonic_merge_smem.tail"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,flip", [(1 << 15, True), (1 << 15, False),
                                    (1 << 17, True), (1 << 17, False)])
def test_cuda_strided_compare_exchange_batched_rows(card, n, flip):
    """K3 (Pallas #7) over 64 rows at each row's largest distance, as the
    batched local sort and post-exchange merges run it."""
    x = _card_keys((64, n))
    got = tmk.strided_compare_exchange(x, n // 2, flip)
    assert torch.equal(got, tmk.strided_compare_exchange_plain(x, n // 2,
                                                               flip))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,m", [(64, 25_003, 256), (70_000, 64, 8)])
def test_cuda_probe_rank_count_batched_rows(card, rows, n, m):
    """K4 as Pallas #6: a distinct probe row per key row; 70,000 rows is
    past gridDim.y's 65,535, the launch limit K4 no longer has."""
    keys = _card_keys((rows, n))
    probes = torch.sort(_card_keys((rows, m), seed=1), dim=-1).values
    got = thk.probe_rank_count(keys, probes)
    torch.cuda.synchronize()
    assert torch.equal(got, thk.probe_ranks_plain(keys, probes))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,m", [(8, 100_003, 256), (64, 25_003, 256),
                                      (70_000, 64, 8), (4, 1, 256),
                                      (4, 31, 256), (4, 33, 256)])
def test_cuda_probe_rank_search(card, rows, n, m):
    """K4s over sorted rows equals its plain version and the counting K4:
    the two main paths' row shapes (cut in length), 70,000 rows (no row
    limit) and rows shorter than, just under and just over a warp."""
    keys = torch.sort(_card_keys((rows, n)), dim=-1).values
    probes = _card_keys((rows, m), seed=1)
    probes[:, ::7] = keys[:, :1]            # probes equal to keys
    before = cuda.launches["probe_rank_search"]
    got = thk.probe_rank_search(keys, probes)
    torch.cuda.synchronize()
    assert cuda.launches["probe_rank_search"] == before + 1
    assert torch.equal(got, thk.probe_ranks_search_plain(keys, probes))
    assert torch.equal(got, thk.probe_rank_count(keys, probes))


def _sample_inputs(dtype, shards, batch, n, m, shared, u_dtype, seed=0):
    """K6's inputs on the card: sorted (shards, batch, n) rows with
    duplicates and a hi-sentinel tail a row; the first round's state and
    one whose interval ends are keys of the rows (a third satisfied); the
    draws; probabilities, request 0's at 1."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    info = torch.iinfo(dtype)
    pool = torch.randint(info.min, info.max, (max(n // 4, 1),),
                         generator=g, device="cuda", dtype=dtype)
    x = pool[torch.randint(0, pool.numel(), (shards, batch, n), generator=g,
                           device="cuda")]
    tails = torch.randint(0, n // 4 + 1, (shards, batch, 1), generator=g,
                          device="cuda")
    x = torch.where(torch.arange(n, device="cuda") >= n - tails, info.max, x)
    x = torch.sort(x, dim=-1).values
    pick = torch.randint(0, n, (batch, 2 * m), generator=g, device="cuda")
    ends = torch.sort(torch.gather(x[0], 1, pick), dim=-1).values
    states = [(torch.full((batch, m), info.min, dtype=dtype, device="cuda"),
               torch.full((batch, m), info.max, dtype=dtype, device="cuda"),
               torch.zeros((batch, m), dtype=torch.bool, device="cuda")),
              (ends[:, 0::2].contiguous(), ends[:, 1::2].contiguous(),
               torch.rand((batch, m), generator=g, device="cuda") < 1 / 3)]
    u = torch.rand((shards, n) if shared else (shards, batch, n),
                   generator=g, device="cuda", dtype=u_dtype)
    prob = torch.rand((batch,), generator=g, device="cuda")
    prob[0] = 1.0
    return x, states, u, prob


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.float64],
                         ids=["u32", "u64"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("batch,n", [(1, 999), (3, 3 * 8192 + 5),
                                     (1, 100_000), (2, 1)])
def test_cuda_sample_compact_matches_plain(card, batch, n, dtype, u_dtype,
                                           shared):
    """K6 (two launches, counted under its key width) against its plain
    version and the torch route's masked sort, under the first round's
    state and a drawn one, at caps that overflow and past the row."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.sample import kernel as tsk

    x, states, u, prob = _sample_inputs(dtype, 8, batch, n, 7, shared,
                                        u_dtype)
    counter = "sample_compact" + (".i64" if dtype == torch.int64 else "")
    for state in states:
        for cap in (32, n + 3):
            before = cuda.launches[counter]
            got = tsk.sample_compact(x, *state, u, prob, cap)
            torch.cuda.synchronize()
            assert cuda.launches[counter] == before + 2
            for want in (tsk.sample_compact_plain(x, *state, u, prob, cap),
                         dispatch.sample_compact(x, *state, u, prob, cap,
                                                 policy="torch")):
                for g, w in zip(got, want):
                    assert torch.equal(g, w)


def _send_inputs(dtype, p, batch, n, seed):
    """(p, B, n) sorted rows with hi-sentinel tails past n_valid, cut by
    splitters drawn from each request's rows -> (rows, starts, counts)."""
    from repro_torch.core.exchange import destination_slices

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    info = torch.iinfo(dtype)
    x = torch.randint(info.min, info.max, (p, batch, n), generator=g,
                      device="cuda", dtype=dtype)
    tails = torch.randint(0, n // 4 + 1, (p, batch), generator=g,
                          device="cuda", dtype=torch.int32)
    x = torch.where(torch.arange(n, device="cuda") >= n - tails[..., None],
                    info.max, x)
    x = torch.sort(x, dim=-1).values
    flat = x.transpose(0, 1).reshape(batch, -1)
    pick = torch.randint(0, flat.shape[1], (batch, p - 1), generator=g,
                         device="cuda")
    spl = torch.sort(torch.gather(flat, 1, pick), dim=-1).values
    return (x, *destination_slices(x, spl, n - tails))


def _check_send(x, starts, counts, cap):
    """One K7 launch, counted under its key width, against its plain
    version (the torch route's index gather)."""
    from repro_torch.kernels.send import kernel as tsend

    sent = torch.clamp(counts, max=cap)
    counter = "dense_send" + (".i64" if x.dtype == torch.int64 else "")
    before = cuda.launches[counter]
    got = tsend.dense_send(x, starts, sent, cap)
    torch.cuda.synchronize()
    assert cuda.launches[counter] == before + 1
    assert torch.equal(got, tsend.dense_send_plain(x, starts, sent, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("p,batch,n", [(2, 1, 10), (3, 3, 999),
                                       (8, 1, 100_003), (8, 5, 4097)])
def test_cuda_dense_send_matches_plain(card, p, batch, n, dtype):
    """K7 on ragged shapes: caps that cut slices and caps past the row,
    multiples of a 16-byte store (vector stores) and not (scalar)."""
    x, starts, counts = _send_inputs(dtype, p, batch, n, seed=p + batch)
    for cap in (1, 3, 8, max(8, n // p), n + 5, 3 * n):
        _check_send(x, starts, counts, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
def test_cuda_dense_send_at_the_benchmark_shape(card, dtype):
    """The benchmark cells' send: (8, 1, 2^25) sorted rows, slices of
    about 2^22 keys, pair_cap 12,582,912: one launch, equal to the plain
    version (the torch route)."""
    from repro_torch.core.exchange import ExchangeConfig

    x, starts, counts = _send_inputs(dtype, 8, 1, 1 << 25, seed=11)
    cap = ExchangeConfig().pair_cap(1 << 25, 8)
    assert cap == 12_582_912
    _check_send(x, starts, counts, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,m", [(8, 100_003, 256), (70_000, 64, 8),
                                      (4, 1, 256), (4, 33, 256)])
def test_cuda_probe_rank_search_int64(card, rows, n, m):
    """K4s's int64 instantiation over sorted 64-bit rows with an INT64_MAX
    tail: equal to its plain version and torch.searchsorted, probes among
    the keys, past both ends and at the sentinel."""
    i64 = torch.iinfo(torch.int64)
    keys = (_card_keys((rows, n)).long() << 31) | _card_keys((rows, n),
                                                             seed=2).abs()
    keys = torch.sort(keys, dim=-1).values
    keys[:, n - n // 5:] = i64.max
    probes = (_card_keys((rows, m), seed=1).long() << 31)
    probes[:, ::7] = keys[:, :1]
    probes[:, 1::7] = i64.max
    probes[:, 2::7] = i64.min
    before = cuda.launches["probe_rank_search.i64"]
    got = thk.probe_rank_search(keys, probes)
    torch.cuda.synchronize()
    assert cuda.launches["probe_rank_search.i64"] == before + 1
    assert torch.equal(got, thk.probe_ranks_search_plain(keys, probes))
    assert torch.equal(got, torch.searchsorted(keys, probes).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("door", ["sort", "argsort"])
def test_cuda_tagged_int64_sort_runs_the_wide_kernels(card, door):
    """tag=True on SKEW2 keys at 2^24 (7 + 24 tag bits: an int64 pack)
    under "auto": the searches and merges launch the int64 K4s and K5 and
    nothing else of the port's, the local sorts run torch.sort; the
    answer equals NumPy's and the torch policy's."""
    from repro_torch.sort import SortSpec, argsort, sort

    x = np.random.default_rng(3).integers(0, 101, 1 << 24).astype(np.int32)
    spec = SortSpec(shards=8, tag=True)
    cuda.reset_launches()
    if door == "sort":
        out = sort(x, spec)
        got = {k for k, v in cuda.launches.items() if v}
        np.testing.assert_array_equal(out.gather(), np.sort(x))
        ref = sort(x, SortSpec(shards=8, tag=True, kernel_policy="torch"))
        assert torch.equal(out.shards, ref.shards)
        assert out.indices.dtype == torch.int64
    else:
        order = argsort(x, spec)
        got = {k for k, v in cuda.launches.items() if v}
        np.testing.assert_array_equal(order, np.argsort(x, kind="stable"))
    assert got == set(cuda.WIDE), got
    assert cuda.launches["merge_path_pairs.i64"] == 3
    assert cuda.launches["dense_send.i64"] == 1


@pytest.mark.cuda
def test_cuda_sort_batched_searches_not_counts(card):
    """Under "kernel" the splitters rank sorted shards with K4s: one
    sort_batched launches it and never the counting K4."""
    from repro_torch.sort import SortSpec, sort_batched

    xs = np.random.default_rng(2).integers(
        0, 2 ** 31 - 1, (4, 8 * 4096)).astype(np.int32)
    cuda.reset_launches()
    out = sort_batched(xs, SortSpec(shards=8, kernel_policy="kernel"))
    assert cuda.launches["probe_rank_search"] > 0
    assert cuda.launches["probe_rank_count"] == 0
    for b in range(4):
        np.testing.assert_array_equal(out.gather(b), np.sort(xs[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["dense", "allgather"])
def test_cuda_sort_batched_matches_numpy_and_torch_policy(card, exchange):
    from repro_torch.sort import SortSpec, sort_batched

    rng = np.random.default_rng(1)
    xs = rng.integers(0, 2 ** 31 - 1, (8, 8 * 32768 + 3)).astype(np.int32)
    cuda.reset_launches()
    out = sort_batched(xs, SortSpec(shards=8, exchange=exchange))
    _assert_main_path_launches(dense=exchange == "dense")
    assert int(out.overflow.max()) == 0
    for b in range(8):
        np.testing.assert_array_equal(out.gather(b), np.sort(xs[b]))
    ref = sort_batched(xs, SortSpec(shards=8, exchange=exchange,
                                    kernel_policy="torch"))
    assert torch.equal(out.shards, ref.shards)
    assert torch.equal(out.counts, ref.counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_cuda_sort_matches_numpy_and_torch_policy(card, dtype):
    from repro_torch.sort import SortSpec, sort

    rng = np.random.default_rng(0)
    n = 8 * 65536 + 5
    if dtype == np.float32:
        x = rng.standard_normal(n).astype(np.float32)
    else:
        x = rng.integers(0, 2 ** 31 - 1, n).astype(dtype)
    cuda.reset_launches()
    out = sort(x, SortSpec(shards=8))
    _assert_main_path_launches()
    assert cuda.launches["merge_path_pairs"] == 3     # ceil(log2 8) levels
    assert int(out.overflow) == 0
    np.testing.assert_array_equal(out.gather(), np.sort(x))
    ref = sort(x, SortSpec(shards=8, kernel_policy="torch"))
    assert torch.equal(out.shards.view(torch.int32),
                       ref.shards.view(torch.int32))
    assert torch.equal(out.counts, ref.counts)


def _presorted(n, reverse=False):
    x = np.linspace(0, 2 ** 30 - 1, n).astype(np.int32)
    return x[::-1].copy() if reverse else x


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("policy", ["retry", "spill"])
def test_cuda_sort_recovers_presorted_input(card, policy, reverse):
    """Presorted keys overflow the dense exchange; retry and spill end
    exact through the kernels, and the torch policy gives the same
    shards."""
    from repro_torch.sort import SortSpec, sort

    x = _presorted(8 * 65536, reverse)
    assert int(sort(x, SortSpec(shards=8)).overflow) > 0
    cuda.reset_launches()
    out = sort(x, SortSpec(shards=8, on_overflow=policy))
    _assert_main_path_launches()
    assert int(out.overflow) == 0
    np.testing.assert_array_equal(out.gather(), np.sort(x))
    if policy == "retry":
        assert out.recovery.attempts > 1
    ref = sort(x, SortSpec(shards=8, on_overflow=policy,
                           kernel_policy="torch"))
    assert torch.equal(out.shards, ref.shards)
    assert torch.equal(out.counts, ref.counts)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["retry", "spill"])
def test_cuda_sort_batched_recovers_presorted_rows(card, policy):
    from repro_torch.sort import SortSpec, sort_batched

    xs = np.stack([_presorted(8 * 16384, reverse=b % 2 == 1)
                   for b in range(4)])
    cuda.reset_launches()
    out = sort_batched(xs, SortSpec(shards=8, on_overflow=policy))
    _assert_main_path_launches(rows_on_chip=True)
    assert int(out.overflow.max()) == 0
    for b in range(4):
        np.testing.assert_array_equal(out.gather(b), np.sort(xs[b]))


@pytest.mark.cuda
def test_cuda_argsort_and_sort_kv_through_the_kernels(card):
    """Keys in [0, 16): 4 key bits + tags pack into int32, so the tagged
    sort runs on the kernels."""
    from repro_torch.sort import SortSpec, argsort, sort_kv

    rng = np.random.default_rng(3)
    ids = rng.integers(0, 16, 8 * 32768).astype(np.int32)
    tokens = np.arange(ids.shape[0]) // 2
    cuda.reset_launches()
    keys, vals = sort_kv(ids, tokens, SortSpec(shards=8,
                                               on_overflow="retry"))
    _assert_main_path_launches()
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(keys, ids[order])
    np.testing.assert_array_equal(vals, tokens[order])
    np.testing.assert_array_equal(
        argsort(ids, SortSpec(shards=8, on_overflow="spill")), order)


@pytest.mark.cuda
def test_cuda_wide_keys_take_the_torch_route(card):
    """int64 packing and float64 keys take the torch route for their
    local sorts and launch only the int64 K4s and K5 (`cuda.WIDE`); every
    output tensor stays on the card."""
    from repro_torch.sort import SortSpec, argsort, sort

    rng = np.random.default_rng(4)
    x = rng.integers(0, 2 ** 30, 8 * 32768).astype(np.int32)
    f = rng.standard_normal(8 * 32768)
    cuda.reset_launches()
    order = argsort(x, SortSpec(shards=8))
    out = sort(x, SortSpec(shards=8, stable=True))
    fout = sort(f, SortSpec(shards=8))
    assert {k for k, v in cuda.launches.items() if v} == set(cuda.WIDE), \
        dict(cuda.launches)
    np.testing.assert_array_equal(order, np.argsort(x, kind="stable"))
    assert out.indices.dtype == torch.int64
    for t in (out.shards, out.counts, out.indices, fout.shards,
              fout.counts):
        assert t.device.type == "cuda"
    np.testing.assert_array_equal(fout.gather(), np.sort(f))


@pytest.mark.cuda
def test_cuda_explicit_kernel_policy_on_int64_raises(card):
    """Under "kernel" an int64 local sort (K1-K3) and count (K4) raise;
    an int64 merge runs K5's int64 instantiation."""
    from repro_torch.kernels import dispatch

    rows = torch.arange(64, dtype=torch.int64, device="cuda").reshape(2, 32)
    with pytest.raises(TypeError, match="K1-K3"):
        dispatch.local_sort(rows, policy="kernel")
    with pytest.raises(TypeError, match="int32"):
        dispatch.probe_ranks(rows, rows[:, :4], policy="kernel")
    before = cuda.launches["merge_path_pairs.i64"]
    got = dispatch.merge_runs(rows.reshape(2, 2, 16), policy="kernel")
    assert cuda.launches["merge_path_pairs.i64"] == before + 1
    assert torch.equal(got, rows)


#: The kernels each algorithm launches (chip_smoke.PATH_KERNELS): the
#: sample sorts rank nothing, so they launch no K4s.
_RANKS = {"sample_random": False, "sample_regular": False, "ams": True,
          "multistage": True, "hss": True}


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,exchange", [
    ("sample_random", "dense"), ("sample_regular", "dense"),
    ("ams", "dense"), ("multistage", "dense"), ("hss", "ragged")])
def test_cuda_algorithms_match_numpy_and_torch_policy(card, algorithm,
                                                      exchange):
    """Under retry each algorithm ends exact through the kernels, with the
    same shards as the torch policy, launches K4s only if it ranks and K7
    only over the dense exchange."""
    from repro_torch.sort import SortSpec, sort

    x = np.random.default_rng(3).integers(0, 2 ** 31 - 1,
                                          8 * 65536 + 5).astype(np.int32)
    spec = SortSpec(shards=8, algorithm=algorithm, exchange=exchange,
                    on_overflow="retry")
    cuda.reset_launches()
    out = sort(x, spec)
    got = dict(cuda.launches)
    assert all(got[k] > 0 for k in ("bitonic_sort_blocks",
                                    "strided_compare_exchange")), got
    assert (got["probe_rank_search"] > 0) == _RANKS[algorithm], got
    assert (got["dense_send"] > 0) == (exchange == "dense"), got
    assert got["probe_rank_count"] == 0, got
    assert int(out.overflow) == 0
    np.testing.assert_array_equal(out.gather(), np.sort(x))
    ref = sort(x, SortSpec(shards=8, algorithm=algorithm, exchange=exchange,
                           on_overflow="retry", kernel_policy="torch"))
    assert torch.equal(out.shards, ref.shards)
    assert torch.equal(out.counts, ref.counts)


@pytest.mark.cuda
def test_cuda_ragged_presorted_takes_the_full_sort_branch(card):
    """Each shard's run (65,536 keys) outgrows the ragged merge's slot
    (2^15): the full local sort of the buffers, exact, no overflow."""
    from repro_torch.kernels.merge import ops as mops
    from repro_torch.sort import SortSpec, sort

    x = _presorted(8 * 65536)
    mops.ragged_branches.clear()
    out = sort(x, SortSpec(shards=8, exchange="ragged"))
    assert dict(mops.ragged_branches) == {"full_sort": 1}
    assert int(out.overflow) == 0
    np.testing.assert_array_equal(out.gather(), np.sort(x))


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("tier", ["cheap", "full"])
def test_cuda_verified_sort_matches_torch_policy(card, tier, batched):
    """The fused audit on the card: it passes, launches no kernel of its
    own, and its words equal the torch policy's."""
    from repro_torch.sort import SortSpec, sort, sort_batched

    rng = np.random.default_rng(4)
    x = rng.integers(0, 2 ** 31 - 1, (4, 8 * 16384 + 3)).astype(np.int32)
    run = sort_batched if batched else sort
    x = x if batched else x[0]
    cuda.reset_launches()
    run(x, SortSpec(shards=8))
    plain = dict(cuda.launches)
    cuda.reset_launches()
    out = run(x, SortSpec(shards=8, verify=tier))
    assert dict(cuda.launches) == plain
    assert out.audit.ok and not out.recovery.verify_fallback
    ref = run(x, SortSpec(shards=8, verify=tier, kernel_policy="torch"))
    assert torch.equal(out._audit_vec, ref._audit_vec)
    assert torch.equal(out.shards, ref.shards)


@pytest.mark.cuda
def test_cuda_corruption_is_caught_and_retried(card):
    from repro_torch.runtime import chaos
    from repro_torch.sort import SortSpec, VerificationError, sort

    x = np.random.default_rng(5).integers(0, 2 ** 30, 8 * 16384)
    x = x.astype(np.int32)
    spec = SortSpec(shards=8, verify="cheap", on_verify_failure="retry")
    with chaos.activate(chaos.FaultPlan(corrupt_at=(0,))):
        out = sort(x, spec)
    assert (out.recovery.verify_failures, out.recovery.verify_retries) == (
        1, 1)
    np.testing.assert_array_equal(out.gather(), np.sort(x))
    with chaos.activate(chaos.FaultPlan(corrupt_at=True)):
        with pytest.raises(VerificationError):
            sort(x, spec)


def _zipf(n, seed=0):
    from repro_torch.data.distributions import make_adversarial
    return make_adversarial("ZIPF_HH", n, seed=seed)


@pytest.mark.cuda
def test_cuda_semisort_matches_torch_policy(card):
    from repro_torch.sort import SortSpec, semisort, semisort_batched

    x = _zipf(8 * 16384 + 5)
    cuda.reset_launches()
    out = semisort(x, spec=SortSpec(shards=8))
    _assert_main_path_launches()
    ref = semisort(x, spec=SortSpec(shards=8, kernel_policy="torch"))
    np.testing.assert_array_equal(out.heavy_keys, ref.heavy_keys)
    np.testing.assert_array_equal(out.heavy_counts, ref.heavy_counts)
    assert torch.equal(out.light.shards, ref.light.shards)
    keys, counts = out.groups()
    uk, uc = np.unique(x, return_counts=True)
    np.testing.assert_array_equal(keys, uk)
    np.testing.assert_array_equal(counts, uc)
    xs = np.stack([_zipf(8 * 4096, seed=s) for s in range(3)])
    batch = semisort_batched(xs, SortSpec(shards=8))
    for b in range(3):
        one = semisort(xs[b], spec=SortSpec(shards=8))
        np.testing.assert_array_equal(batch.request(b).heavy_keys,
                                      one.heavy_keys)
        assert torch.equal(batch.request(b).light.shards, one.light.shards)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_cuda_top_k_matches_torch_policy(card, dtype):
    from repro_torch.sort import SortSpec, top_k, top_k_batched

    x = np.random.default_rng(6).integers(0, 2 ** 31 - 1, (3, 8 * 32768 + 1))
    x = x.astype(dtype)
    cuda.reset_launches()
    got = top_k(x[0], 1000, SortSpec(shards=8))
    assert cuda.launches["bitonic_sort_blocks"] > 0
    assert cuda.launches["probe_rank_search"] == 0
    ref = top_k(x[0], 1000, SortSpec(shards=8, kernel_policy="torch"))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.sort(x[0])[::-1][:1000])
    rows = top_k_batched(x, 1000, SortSpec(shards=8))
    for b in range(3):
        np.testing.assert_array_equal(rows[b], np.sort(x[b])[::-1][:1000])


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["count", "sum", "mean", "max"])
def test_cuda_groupby_aggregate_matches_torch_policy(card, op):
    from repro_torch.sort import SortSpec, groupby_aggregate

    rng = np.random.default_rng(7)
    ids = rng.integers(0, 16, 8 * 16384).astype(np.int32)
    v = rng.standard_normal(ids.shape[0]).astype(np.float32)
    vals = None if op == "count" else v
    got = groupby_aggregate(ids, vals, op=op, spec=SortSpec(shards=8))
    ref = groupby_aggregate(ids, vals, op=op,
                            spec=SortSpec(shards=8, kernel_policy="torch"))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0], np.arange(16))


@pytest.mark.cuda
def test_cuda_counting_dispatch_matches_argsort_and_cpu(card):
    from repro_torch.sort.grouping import counting_dispatch

    ids = np.random.default_rng(8).integers(-1, 16, 100_003).astype(np.int32)
    dev = torch.from_numpy(ids).cuda()
    cuda.reset_launches()
    got = counting_dispatch(dev, 16, 7_000)
    assert not any(cuda.launches.values())
    for g, a, c in zip(got, counting_dispatch(dev, 16, 7_000,
                                              method="argsort"),
                       counting_dispatch(torch.from_numpy(ids), 16, 7_000)):
        assert torch.equal(g, a)
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sort", "sort_kv", "semisort", "top_k",
                                  "argsort"])
def test_cuda_service_batch_launches_the_kernels(card, kind):
    """One full batch of each kind through ServiceRunner on the card:
    every result exact, and the kernels of its path launched (argsort of
    full-range int32 keys packs int64: its searches and merges launch the
    int64 K4s and K5, its local sorts run torch.sort)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.serve import ServiceConfig, ServiceRunner
    from repro_torch.sort import SortSpec

    rng = np.random.default_rng(9)
    n = 8 * 16384
    if kind == "sort_kv":
        xs = [rng.integers(0, 16, n).astype(np.int32) for _ in range(4)]
    elif kind == "semisort":
        xs = [_zipf(n, seed=s) for s in range(4)]
    else:
        xs = [rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
              for _ in range(4)]
    values = np.arange(n, dtype=np.int32)
    spec = SortSpec(shards=8)
    if kind in ("sort_kv", "argsort"):
        spec = SortSpec(shards=8, stable=True)
    with ServiceRunner(spec=spec, config=ServiceConfig(
            max_batch=4, max_delay_ms=1000.0)) as runner:
        cuda.reset_launches()
        with ThreadPoolExecutor(4) as pool:
            out = list(pool.map(lambda x: runner.submit(
                x, kind=kind, values=values if kind == "sort_kv" else None,
                param=1024 if kind == "top_k" else None), xs))
        torch.cuda.synchronize()
        launched = dict(cuda.launches)
        snap = runner.metrics()
    assert snap["batches"] == 1 and snap["degraded_requests"] == 0
    for x, got in zip(xs, out):
        order = np.argsort(x, kind="stable")
        if kind == "sort":
            np.testing.assert_array_equal(got, np.sort(x))
        elif kind == "sort_kv":
            np.testing.assert_array_equal(got[0], x[order])
            np.testing.assert_array_equal(got[1], values[order])
        elif kind == "semisort":
            keys, counts = np.unique(got, return_counts=True)
            uk, uc = np.unique(x, return_counts=True)
            np.testing.assert_array_equal(keys, uk)
            np.testing.assert_array_equal(counts, uc)
            assert 1 + np.count_nonzero(got[1:] != got[:-1]) == len(uk)
        elif kind == "top_k":
            np.testing.assert_array_equal(got, np.sort(x)[::-1][:1024])
        else:
            np.testing.assert_array_equal(got, order)
    if kind == "argsort":
        assert {k for k, v in launched.items() if v} == set(cuda.WIDE), \
            launched
    elif kind == "top_k":
        assert launched["bitonic_sort_blocks"] > 0, launched
        assert launched["probe_rank_search"] == 0, launched
        assert launched["probe_rank_count"] == 0, launched
    else:   # 16,384-key shard rows: local sorts on chip, merges by K5
        assert all(launched[k] > 0 for k in cuda.COUNTERS
                   if k not in cuda.OFF_MAIN_PATH + HBM_PASSES + cuda.WIDE
                   ), launched
        assert all(launched[k] == 0 for k in cuda.OFF_MAIN_PATH), launched


@pytest.mark.cuda
def test_cuda_sync_audit_raises_on_an_undocumented_sync(card):
    """Under the audit's "error" mode a raw device-to-host read raises; a
    documented site lets its own through and counts it."""
    from repro_torch.analysis import purity
    from repro_torch.runtime.syncs import sync_site

    x = _card_keys((1024,))
    with pytest.raises(purity.HostSyncViolation):
        purity.count_host_syncs(lambda: int(x.max()), device="cuda")

    def documented():
        with sync_site("gather"):
            return int(x.max())

    audit = purity.count_host_syncs(documented, device="cuda")
    assert audit.result == int(x.max()) and audit.syncs == {"gather": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("door", ["sort", "sort_batched", "argsort",
                                  "sort_kv", "semisort", "top_k",
                                  "sort[retry]", "sort[verify=full]"])
def test_cuda_front_door_syncs_match_their_pinned_formula(card, door):
    from repro_torch.analysis import lint, purity

    call, batch = lint.purity_doors("cuda")[door]
    call()
    audit = purity.count_host_syncs(call, device="cuda")
    purity.check_pinned(door, audit, batch)


@pytest.mark.cuda
def test_cuda_card_input_on_a_cpu_spec_is_copied_before_it_is_read(card):
    """Card tensors given to a CPU sort (keys and injected draws) come to
    the host with a blocking copy, and a pinned source's upload is done
    before the call returns, so the caller may overwrite it."""
    from repro_torch.runtime import syncs
    from repro_torch.sort import SortSpec, sort

    x = _card_keys((8 * 4096,), seed=5)
    draws = lambda j, n: torch.rand((8, n), device="cuda")  # noqa: E731
    assert not syncs.queues_upload(x, "cpu")
    got = sort(x, SortSpec(device="cpu"), uniform=draws).gather()
    np.testing.assert_array_equal(got, np.sort(x.cpu().numpy()))
    host = syncs.move(x, "cpu")
    assert torch.equal(host, x.cpu())

    src = torch.arange(1 << 22, dtype=torch.int64).pin_memory()
    assert not syncs.queues_upload(src, "cuda")
    up = syncs.to_device(src, torch.int64, "cuda")
    src.zero_()
    assert torch.equal(up.cpu(), torch.arange(1 << 22, dtype=torch.int64))


@pytest.mark.cuda
def test_cuda_probe_counts_launches_the_counting_kernel(card):
    from repro_torch.kernels.histogram import ops as hops

    x = _card_keys((1 << 20,))
    q = torch.sort(_card_keys((256,), seed=3)).values
    cuda.reset_launches()
    got = hops.probe_counts(x, q)
    torch.cuda.synchronize()
    assert cuda.launches["probe_rank_count"] == 1
    assert sum(cuda.launches.values()) == 1
    want = hops.probe_counts(x.cpu(), q.cpu(), policy="torch")
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_legacy_hss_sort_equals_the_front_door(card):
    from repro_torch.core import hss
    from repro_torch.sort import SortSpec, sort

    x = _card_keys((8 * 65536,))
    got = hss.hss_sort(x)
    front = sort(x, SortSpec(tag=False))
    assert torch.equal(got.shards, front.shards)
    np.testing.assert_array_equal(hss.gather_sorted(got),
                                  np.sort(x.cpu().numpy()))
