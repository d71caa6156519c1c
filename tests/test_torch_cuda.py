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


def _assert_main_path_launches():
    """Every kernel of the main paths launched; the counting K4, which
    only `assume_sorted=False` reaches, did not."""
    got = dict(cuda.launches)
    assert all(got[k] > 0 for k in cuda.COUNTERS
               if k not in cuda.OFF_MAIN_PATH), got
    assert all(got[k] == 0 for k in cuda.OFF_MAIN_PATH), got


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
    _assert_main_path_launches()
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
    _assert_main_path_launches()
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
    """int64 packing and float64 keys launch no kernel; every output
    tensor stays on the card."""
    from repro_torch.sort import SortSpec, argsort, sort

    rng = np.random.default_rng(4)
    x = rng.integers(0, 2 ** 30, 8 * 32768).astype(np.int32)
    f = rng.standard_normal(8 * 32768)
    cuda.reset_launches()
    order = argsort(x, SortSpec(shards=8))
    out = sort(x, SortSpec(shards=8, stable=True))
    fout = sort(f, SortSpec(shards=8))
    assert sum(cuda.launches.values()) == 0, dict(cuda.launches)
    np.testing.assert_array_equal(order, np.argsort(x, kind="stable"))
    assert out.indices.dtype == torch.int64
    for t in (out.shards, out.counts, out.indices, fout.shards,
              fout.counts):
        assert t.device.type == "cuda"
    np.testing.assert_array_equal(fout.gather(), np.sort(f))


@pytest.mark.cuda
def test_cuda_explicit_kernel_policy_on_int64_raises(card):
    from repro_torch.kernels import dispatch

    rows = torch.arange(64, dtype=torch.int64, device="cuda").reshape(2, 32)
    with pytest.raises(TypeError, match="int32"):
        dispatch.local_sort(rows, policy="kernel")
    with pytest.raises(TypeError, match="int32"):
        dispatch.merge_runs(rows.reshape(2, 2, 16), policy="kernel")


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
    same shards as the torch policy, and launches K4s only if it ranks."""
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
    full-range int32 keys packs int64: the torch route, no kernel)."""
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
        assert not any(launched.values()), launched
    elif kind == "top_k":
        assert launched["bitonic_sort_blocks"] > 0, launched
        assert launched["probe_rank_search"] == 0, launched
        assert launched["probe_rank_count"] == 0, launched
    else:
        assert all(launched[k] > 0 for k in cuda.COUNTERS
                   if k not in cuda.OFF_MAIN_PATH), launched
        assert all(launched[k] == 0 for k in cuda.OFF_MAIN_PATH), launched
