"""The yardstick's arithmetic: generators and pools that repeat from the
seed, the reservoir of checked answers, the spread, the roofline, the
reference's comparisons, and the reductions of a device timeline."""
import math
import statistics

import numpy as np
import pytest
import torch

from hssbench import distributions, reference, roofline, stats, traffic
from hssbench.devtrace import Timeline, kind_of

MIX = {"distribution": "UNIF", "pool": 3, "input": "device",
       "result": "device", "warmup": 1, "check": 4}


@pytest.mark.parametrize("name", sorted(distributions.DISTRIBUTIONS))
def test_generators_repeat_from_the_seed(name):
    def make(seed):
        return distributions.make_keys(name, 5000, seed, "cpu")
    a, b, c = make(2 ** 63 + 7), make(2 ** 63 + 7), make(2 ** 63 + 8)
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert 0 <= int(a.min()) and int(a.max()) < \
        distributions.DISTRIBUTIONS[name]


def test_pool_repeats_and_takes_large_and_negative_seeds():
    for seed in (0, 2 ** 31 + 5, 2 ** 40, -3):
        a = traffic.make_pool(MIX, 1000, seed, "cpu")
        b = traffic.make_pool(MIX, 1000, seed, "cpu")
        assert len(a) == 3 and all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], a[1])
    host = traffic.make_pool({**MIX, "input": "host"}, 1000, 9, "cpu")
    assert all(isinstance(x, np.ndarray) and x.dtype == np.int32
               for x in host)
    assert np.array_equal(host[1],
                          traffic.make_pool(MIX, 1000, 9, "cpu")[1].numpy())


def test_reservoir_is_uniform_and_seeded():
    kept = []
    for seed in range(400):
        r = traffic.Reservoir(2, seed)
        for i in range(10):
            r.offer(lambda i=i: i)
        kept += r.items
    counts = np.bincount(kept, minlength=10)
    assert counts.min() > 40 and counts.max() < 120
    r1, r2 = traffic.Reservoir(3, 9), traffic.Reservoir(3, 9)
    for i in range(50):
        r1.offer(lambda i=i: i)
        r2.offer(lambda i=i: i)
    assert r1.items == r2.items


def test_reference_counts_wrong_and_missing_keys():
    keys = torch.tensor([5, 3, 9, 1], dtype=torch.int32)
    shards = torch.tensor([[1, 3, 0], [5, 9, 0]], dtype=torch.int32)
    counts = torch.tensor([2, 2], dtype=torch.int32)
    answer = reference.valid_keys(shards, counts)
    assert reference.wrong_keys(answer, torch.sort(keys).values) == 0
    assert reference.wrong_keys(answer[:3], torch.sort(keys).values) == 1
    assert reference.wrong_keys(answer.flip(0), torch.sort(keys).values) == 4
    assert reference.imbalance_excess(counts, 4) == 0.0
    assert reference.imbalance_excess(torch.tensor([3, 1]), 4) == 0.5
    cmp = reference.Comparison()
    cmp.answer(answer, keys)
    cmp.balance(torch.tensor([3, 1]), 4)
    checks = cmp.checks({"balance_eps": 0.05}, failed=0)
    assert checks["wrong_keys"]["ok"] and checks["answers_checked"]["ok"]
    assert checks["calls_failed"]["ok"]
    assert not checks["imbalance_excess"]["ok"]
    assert not cmp.checks({"balance_eps": 0.05}, failed=1)[
        "calls_failed"]["ok"]


def test_spread_is_statistics_quartiles():
    v = [10.0, 11.0, 9.5, 10.2, 10.4, 9.9]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_roofline_on_known_shapes():
    assert roofline.least_bytes(16_000_000) == 384_000_000
    bw = roofline.peak_bandwidth("NVIDIA H100 80GB HBM3")
    assert bw == 3.35e12
    least = 384e6 / 3.35e12
    assert roofline.roofline_pct(16_000_000, least, bw) == pytest.approx(100)
    assert roofline.roofline_pct(16_000_000, 10 * least, bw) == \
        pytest.approx(10)
    assert roofline.roofline_pct(16_000_000, 0.0, bw) is None
    with pytest.raises(KeyError):
        roofline.peak_bandwidth("cpu")


def test_kinds():
    assert kind_of("Memcpy HtoD (Pageable -> Device)") == "memcpy_htod"
    assert kind_of("Memcpy DtoH (Device -> Pageable)") == "memcpy_dtoh"
    assert kind_of("Memset (Device)") == "memset"
    assert kind_of("bitonic_sort_warp_kernel<1024>") == "kernel"
    assert kind_of("Stream Sync") is None


def test_timeline_busy_gaps_and_names():
    ms = 10 ** 6
    events = [("k1", "kernel", 0 * ms, 2 * ms),
              ("k2", "kernel", 1 * ms, 3 * ms),
              ("Memcpy HtoD", "memcpy_htod", 5 * ms, 6 * ms),
              ("k3", "kernel", 9 * ms, 12 * ms),      # clipped at 10
              ("early", "kernel", -5 * ms, -4 * ms)]  # before the window
    t = Timeline(events, 0, 10 * ms)
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_intervals() == [(0, 3 * ms), (5 * ms, 6 * ms),
                                  (9 * ms, 10 * ms)]
    assert t.busy_s() == pytest.approx(0.005)
    assert t.gaps() == [(3 * ms, 5 * ms), (6 * ms, 9 * ms)]
    assert t.seconds("kernel") == pytest.approx(0.005)
    assert t.count("memcpy_htod") == 1
    spans = [("sort", 0, 4500000), ("gather", 4500000, 5 * ms)]
    assert t.idle_by_host(spans, "between calls") == [
        ["between calls", 0.003], ["sort", 0.002]]
    top = t.top_ops(2)
    assert {n for n, _ in top} == {"k1", "k2"}
    assert [v for _, v in top] == pytest.approx([0.002, 0.002])
    assert t.summary()["in_window"] == 4
    assert math.isclose(t.summary()["first_vs_t0_ms"], -5.0)
