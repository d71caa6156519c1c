"""The two-stage cell, `sort.card_ms8x8`, on the CPU: its new readers on
synthetic records and None where the port has nothing for them to read (a
port without the `stage1` and `stage2` spans), the stage spans read on a
real traced two-stage sort, and tiny runs of the cell (64 shards of 256
keys) against the plain reference, the two-stage reference's stage
bounds, its control and faults planted where the two-stage path runs."""
import gc
import importlib
import time

import numpy as np
import pytest
import torch

import hssbench.test_hssbench_run as run_tests
import hssbench.test_hssbench_spans as base
from hssbench import harness
from hssbench.devtrace import Timeline
from hssbench.reference_two_stage import part_limit, stage_checks

CELL = "sort.card_ms8x8"
CONFIG = "hss_ms8x8_p64_2p28"
CPU = {"device": "cpu", "kernel_policy": "torch"}
TINY_KEYS = 64 * 256
SECONDS = 0.25
BANDWIDTH = 3.35e12
#: One two-stage call's spans (name, id offset, parent offset, stream
#: start and end in µs from the root's entry), in the shape the port
#: records them.
CALL = [
    ("sort", 0, None, 0, 2900),
    ("plan", 1, 0, 100, 500),
    ("local_sort", 2, 0, 600, 1000),
    ("stage1", 3, 0, 1100, 1900),
    ("splitters", 4, 3, 1100, 1300),
    ("exchange", 5, 3, 1350, 1850),
    ("merge", 6, 5, 1500, 1800),
    ("stage2", 7, 0, 1950, 2850),
    ("splitters", 8, 7, 1950, 2150),
    ("exchange", 9, 7, 2200, 2800),
    ("merge", 10, 9, 2300, 2700),
]
EXPECTED = {
    "multistage.stage1_ms": 0.8,
    "multistage.stage2_ms": 0.9,
    "driver.local_sort_ms": 0.4,
    "splitters.stream_ms": 0.4,
    "exchange.send_ms": 0.2 + 0.2,
    "exchange.merge_ms": 0.7,
}
NEW_SPANS = ("multistage.stage1_ms", "multistage.stage2_ms")


@pytest.fixture(autouse=True)
def _unfreeze():
    """A run ends its set-up with `gc.freeze()`; give the collector its
    objects back for the files that follow."""
    yield
    gc.unfreeze()


def two_stage_spans():
    spans = []
    for k, t0 in enumerate(base.CALL_STARTS):
        root = 20 * (k + 1)
        for name, i, parent, s, e in CALL:
            spans.append({"name": name, "id": root + i,
                          "parent": None if parent is None else root + parent,
                          "call": root, "start_ns": (t0 + s // 3) * base.US,
                          "end_ns": (t0 + e // 3) * base.US,
                          "stream_ms": (e - s) / 1e3,
                          "stream_start_ms": s / 1e3})
    return spans


def reading(calls=base.CALLS, launches=None, timeline="synthetic",
            bandwidth=BANDWIDTH):
    tl = base.synthetic_timeline() if timeline == "synthetic" else timeline
    r = harness.Reading(calls, calls * TINY_KEYS,
                        {"syncs": {}, "launches": launches or {}}, tl)
    r.bandwidth = bandwidth
    return r


def read(metric, r):
    return harness.load_reader(metric + ".grid")(r)


def _record(monkeypatch, spans):
    from repro_torch.runtime import trace
    monkeypatch.setattr(trace, "spans", lambda: list(spans))


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_span_readers_on_a_synthetic_two_stage_record(metric, monkeypatch):
    """Each stage's splitters and exchange add into the phase readers; the
    stage readers read their own span."""
    _record(monkeypatch, two_stage_spans())
    assert read(metric, reading()) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", NEW_SPANS)
def test_stage_readers_on_a_port_without_the_spans_are_none(metric,
                                                            monkeypatch):
    """The parent's port opens no stage span: nothing to read, no raise."""
    _record(monkeypatch, [s for s in two_stage_spans()
                          if not s["name"].startswith("stage")])
    assert read(metric, reading()) is None
    assert read(metric, reading(timeline=None)) is None


def test_local_sort_roofline_is_the_least_time_over_the_span(monkeypatch):
    """2 x 4 bytes a key of a call at the peak over the `local_sort`
    span's 0.4 ms a call."""
    _record(monkeypatch, two_stage_spans())
    want = 100.0 * (8 * TINY_KEYS / BANDWIDTH) / 0.4e-3
    got = read("kernels.local_sort_roofline_pct", reading())
    assert got == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_bandwidth", "no_call", "no_span"])
def test_local_sort_roofline_with_nothing_to_read_is_none(case,
                                                          monkeypatch):
    _record(monkeypatch, [s for s in two_stage_spans()
                          if case != "no_span" or s["name"] != "local_sort"])
    r = reading(calls=0 if case == "no_call" else base.CALLS,
                bandwidth=None if case == "no_bandwidth" else BANDWIDTH)
    assert read("kernels.local_sort_roofline_pct", r) is None


@pytest.mark.parametrize("launches,want", [
    ({"bitonic_sort_blocks": 6, "bitonic_merge_smem.reverse": 12,
      "bitonic_merge_smem.tail": 9, "strided_compare_exchange": 30,
      "merge_path_pairs": 12, "dense_send": 6}, 19.0),
    ({"bitonic_sort_blocks": 3, "merge_path_pairs": 9}, 1.0),
    ({"merge_path_pairs": 9, "probe_rank_search": 12}, None),
    ({}, None),
])
def test_local_sort_launches_counts_k1_to_k3(launches, want):
    """K1, K2 in both roles and K3 count, a call at a time; a window in
    which "auto" sent no row to them reads None."""
    got = read("kernels.local_sort_launches", reading(launches=launches))
    assert got == (None if want is None else pytest.approx(want))


def test_every_metric_of_the_cell_has_a_reader():
    bench = harness.load_benchmark()
    names = {m["name"] for m in harness.per_layer_for(bench, CELL)}
    assert len(names) == 11
    assert {"multistage.stage1_ms.grid", "multistage.stage2_ms.grid",
            "kernels.local_sort_roofline_pct.grid",
            "kernels.local_sort_launches.grid"} <= names
    for name in names:
        assert harness.reader_path(name).exists()
    e2e = {m["name"] for m in harness.end_to_end_for(bench, CELL)}
    assert e2e == {"card_sort_keys_per_s", "setup_s"}


def test_stage_spans_read_on_a_traced_two_stage_sort():
    """A real traced two-stage sort on the CPU: `stage1` and `stage2` each
    hold one `splitters` and one `exchange`, the local sort lies outside
    both, and the root's children add up to its stream time a call."""
    from repro_torch.runtime import trace
    from repro_torch.sort import SortSpec, sort
    x = np.random.default_rng(6).integers(
        -2 ** 31, 2 ** 31 - 1, TINY_KEYS, dtype=np.int64).astype(np.int32)
    spec = SortSpec(**{**harness.load_config(CONFIG)["spec"], **CPU})
    trace.clear()
    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            out = sort(x, spec)
    t1 = time.time_ns()
    np.testing.assert_array_equal(out.gather(), np.sort(x))
    spans = trace.spans()
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert names.count("stage1") == names.count("stage2") == 2
    assert names.count("splitters") == names.count("exchange") == 4
    for stage in ("stage1", "stage2"):
        for s in (s for s in spans if s["name"] == stage):
            assert by_id[s["parent"]]["name"] == "sort"
            kids = [k["name"] for k in spans if k["parent"] == s["id"]]
            assert kids == ["splitters", "exchange"]
    for s in (s for s in spans if s["name"] == "local_sort"):
        assert by_id[s["parent"]]["name"] == "sort"
    r = harness.Reading(2, 2 * x.size, {}, Timeline(
        [("k", "kernel", t0, t1)], t0, t1))
    stream = ["front.plan_ms", "driver.local_sort_ms", "driver.self_ms",
              "multistage.stage1_ms", "multistage.stage2_ms"]
    values = {m: read(m, r) for m in stream}
    assert all(v is not None and v >= 0 for v in values.values()), values
    roots = [s["stream_ms"] for s in spans if s["parent"] is None]
    assert sum(values.values()) == pytest.approx(sum(roots) / 2)
    inner = sum(read(m, r) for m in ("splitters.stream_ms",
                                     "exchange.send_ms", "exchange.merge_ms"))
    assert inner <= values["multistage.stage1_ms"] + \
        values["multistage.stage2_ms"] + 1e-9
    trace.clear()


# -- tiny runs of the cell ----------------------------------------------

def tiny_run(seed=2 ** 31 + 41, trace=False, spec=None):
    return harness.run_cell(CELL, seed, SECONDS, trace,
                            t_start=time.perf_counter(),
                            spec_overrides={**CPU, **(spec or {})},
                            mix_overrides={"warmup": 1, "check": 3},
                            keys=TINY_KEYS)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cpu_run_of_the_two_stage_cell_matches_the_reference(trace):
    line, notes = tiny_run(trace=trace)
    assert line["correct"], line["checks"]
    assert line["checks"]["wrong_keys"] == {"value": 0, "limit": 0}
    assert line["checks"]["imbalance_excess"]["limit"] == 0.1025
    assert notes["done"] == line["attempted"] >= 1
    bench = harness.load_benchmark()
    if trace:
        names = {m["name"] for m in harness.per_layer_for(bench, CELL)}
        assert set(line["metrics"]) <= names
    else:
        assert set(line["metrics"]) == {"card_sort_keys_per_s", "setup_s"}


def test_the_cells_answers_keep_the_stage_bounds(monkeypatch):
    """The checked answers of a tiny run hold the two-stage reference's
    bounds: each group within (1 + eps) N / r1, each shard within
    (1 + eps) G / r2 of its group and (1 + eps)^2 N / p."""
    seen = []
    orig = harness.compare

    def compare(run, w):
        for idx, answer, counts in w.answers:
            seen.append(stage_checks(w.pool[idx], answer, counts, 8, 8,
                                     run.spec.eps))
        return orig(run, w)

    monkeypatch.setattr(harness, "compare", compare)
    line, _ = tiny_run()
    assert line["correct"]
    assert len(seen) == line["checks"]["answers_checked"]["value"] >= 1
    for checks in seen:
        assert all(c["ok"] for c in checks.values()), checks
        assert checks["wrong_keys"]["value"] == 0


def test_the_configuration_is_the_paper_grid():
    """p = 64 as the (8, 8) grid of `factor_stages`, 2^22 keys a shard at
    the published eps, and `balance_eps` the two stages' (1 + eps)^2 - 1."""
    from repro_torch.sort import SortSpec
    from repro_torch.sort.driver import factor_stages
    cfg = harness.load_config(CONFIG)
    spec = SortSpec(**cfg["spec"])
    assert spec.algorithm == "multistage" and spec.stages is None
    assert factor_stages(spec.shards) == (8, 8)
    assert cfg["keys"] // spec.shards == 1 << 22
    eps = spec.eps
    assert cfg["guarantees"]["balance_eps"] == pytest.approx(
        (1 + eps) ** 2 - 1)
    # whole keys take the bound no further than a few keys a shard
    n = cfg["keys"]
    worst = part_limit(part_limit(n, 8, eps), 8, eps)
    assert worst * 64 / n - 1 - cfg["guarantees"]["balance_eps"] < 1e-5


def test_control_of_the_two_stage_cell_is_not_correct():
    control = harness.load_config(CONFIG)["control"]
    line, _ = tiny_run(spec=control["spec"])
    assert not line["correct"]


#: Faults where the two-stage path runs: MultistagePartitioner overrides
#: `sharded_batched`, and `core/multistage` calls its own import of
#: `exchange_batched`.
FAULTS = {
    "unchanged": ("repro_torch.sort.partitioners", "MultistagePartitioner",
                  "sharded_batched", run_tests._unchanged),
    "half_left_out": ("repro_torch.sort.partitioners",
                      "MultistagePartitioner", "sharded_batched",
                      run_tests._half_left_out),
    "no_exchange": ("repro_torch.core.multistage", None, "exchange_batched",
                    run_tests._no_exchange),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_the_two_stage_path_is_not_correct(fault, monkeypatch):
    module, cls, attr, make = FAULTS[fault]
    target = importlib.import_module(module)
    if cls is not None:
        target = getattr(target, cls)
    monkeypatch.setattr(target, attr, make(getattr(target, attr)))
    line, _ = tiny_run()
    assert not line["correct"], (fault, line["checks"])
