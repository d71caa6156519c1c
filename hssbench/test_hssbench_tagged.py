"""The tagged cell, `sort.card_skew2_tag`, on the CPU: its readers on
synthetic records (in the style of `test_hssbench_spans.py`), None where
the port has nothing for them to read (a port without the `pack` and
`unpack` spans or the `.i64` counters), the pack and unpack spans read on
a real traced tagged sort, and tiny runs of the cell against the plain
reference, its control and a planted fault."""
import gc
import time

import numpy as np
import pytest
import torch

import hssbench.test_hssbench_spans as base
from hssbench import harness
from hssbench.devtrace import Timeline

CELL = "sort.card_skew2_tag"
CPU = {"device": "cpu", "kernel_policy": "torch"}
TINY_KEYS = 8 * 2048
SECONDS = 0.25
BANDWIDTH = 3.35e12
#: The new readers' metrics; each call's `pack` and `unpack` spans take
#: the first and the last 100 µs of the root's stream time.
PACK = ("pack", 6, 0, 0, 100)
UNPACK = ("unpack", 7, 0, 2800, 2900)
EXPECTED = {"front.pack_ms": 0.1, "front.unpack_ms": 0.1}


@pytest.fixture(autouse=True)
def _unfreeze():
    """A run ends its set-up with `gc.freeze()`; give the collector its
    objects back for the files that follow."""
    yield
    gc.unfreeze()


def tagged_spans():
    """`test_hssbench_spans`' synthetic calls, each with a pack and an
    unpack span under its root."""
    spans = base.synthetic_spans()
    for k, t0 in enumerate(base.CALL_STARTS):
        root = 10 * (k + 1)
        for name, i, parent, s, e in (PACK, UNPACK):
            spans.append({"name": name, "id": root + i, "parent": root,
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
    return harness.load_reader(metric + ".tag")(r)


@pytest.fixture
def record(monkeypatch):
    from repro_torch.runtime import trace
    spans = tagged_spans()
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return spans


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_span_readers_on_a_synthetic_record(metric, record):
    assert read(metric, reading()) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_span_readers_of_an_untagged_record_are_none(metric, monkeypatch):
    """The parent's port, and an untagged call, open no pack or unpack
    span: nothing to read, and no raise."""
    from repro_torch.runtime import trace
    spans = base.synthetic_spans()
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    assert read(metric, reading()) is None
    assert read(metric, reading(timeline=None)) is None


def test_the_other_stream_readers_are_unmoved_by_the_tag_spans(record):
    """The tag spans are the root's children: the root's self time gives
    up their time, every other phase reads as before."""
    r = reading()
    for metric in ("front.plan_ms", "exchange.merge_ms", "exchange.send_ms"):
        assert read(metric, r) == pytest.approx(base.EXPECTED[metric])
    assert read("driver.self_ms", r) == pytest.approx(
        base.EXPECTED["driver.self_ms"] - 0.2)


@pytest.mark.parametrize("launches,want", [
    ({"merge_path_pairs.i64": 9, "probe_rank_search.i64": 12,
      "merge_path_pairs": 30}, 7.0),
    ({"merge_path_pairs.i64": 9, "probe_rank_search.i64": 0}, 3.0),
    ({"merge_path_pairs": 9, "probe_rank_search": 12}, None),
    ({}, None),
])
def test_wide_launches_counts_the_int64_counters(launches, want):
    """Only the `.i64` counters count, a call at a time; a port with no
    such counter (the parent) or a window without one reads None."""
    got = read("kernels.wide_launches", reading(launches=launches))
    assert got == (None if want is None else pytest.approx(want))


def test_wide_launches_without_a_call_is_none():
    assert read("kernels.wide_launches", reading(
        calls=0, launches={"merge_path_pairs.i64": 3})) is None


def test_merge_roofline_is_the_least_time_over_the_merge_span(record):
    """2 x 4 bytes a key of a call at the peak over the `merge` span's
    0.8 ms a call."""
    want = 100.0 * (8 * TINY_KEYS / BANDWIDTH) / 0.8e-3
    got = read("kernels.merge_roofline_pct", reading())
    assert got == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_bandwidth", "no_call", "no_span"])
def test_merge_roofline_with_nothing_to_read_is_none(case, monkeypatch):
    from repro_torch.runtime import trace
    spans = [s for s in tagged_spans()
             if case != "no_span" or s["name"] != "merge"]
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    r = reading(calls=0 if case == "no_call" else base.CALLS,
                bandwidth=None if case == "no_bandwidth" else BANDWIDTH)
    assert read("kernels.merge_roofline_pct", r) is None


def test_every_new_metric_of_the_cell_has_a_reader():
    bench = harness.load_benchmark()
    names = {m["name"] for m in harness.per_layer_for(bench, CELL)}
    assert {"front.pack_ms.tag", "front.unpack_ms.tag",
            "kernels.wide_launches.tag",
            "kernels.merge_roofline_pct.tag"} <= names
    for name in names:
        assert harness.reader_path(name).exists()
    e2e = {m["name"] for m in harness.end_to_end_for(bench, CELL)}
    assert e2e == {"card_sort_keys_per_s", "setup_s"}


def test_pack_and_unpack_read_on_a_traced_tagged_sort():
    """A real traced sort of SKEW2 keys with tag=True on the CPU: both
    tag spans read, and the stream metrics, the tag spans among them,
    add up to the root's stream time a call."""
    from repro_torch.runtime import trace
    from repro_torch.sort import SortSpec, sort
    x = np.random.default_rng(4).integers(0, 101, TINY_KEYS, dtype=np.int32)
    trace.clear()
    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            out = sort(x, SortSpec(device="cpu", tag=True))
    t1 = time.time_ns()
    np.testing.assert_array_equal(out.gather(), np.sort(x))
    r = harness.Reading(2, 2 * x.size, {}, Timeline(
        [("k", "kernel", t0, t1)], t0, t1))
    stream = ["front.plan_ms", "front.pack_ms", "driver.local_sort_ms",
              "driver.self_ms", "splitters.stream_ms", "exchange.send_ms",
              "exchange.merge_ms", "front.unpack_ms"]
    values = {m: read(m, r) for m in stream}
    assert all(v is not None and v >= 0 for v in values.values()), values
    roots = [s["stream_ms"] for s in trace.spans() if s["parent"] is None]
    assert sum(values.values()) == pytest.approx(sum(roots) / 2)
    trace.clear()


# -- tiny runs of the cell ----------------------------------------------

def tiny_run(seed=2 ** 31 + 29, trace=False, spec=None):
    return harness.run_cell(CELL, seed, SECONDS, trace,
                            t_start=time.perf_counter(),
                            spec_overrides={**CPU, **(spec or {})},
                            mix_overrides={"warmup": 1, "check": 3},
                            keys=TINY_KEYS)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cpu_run_of_the_tagged_cell_matches_the_reference(trace):
    line, notes = tiny_run(trace=trace)
    assert line["correct"], line["checks"]
    assert line["checks"]["wrong_keys"] == {"value": 0, "limit": 0}
    assert notes["done"] == line["attempted"] >= 1
    bench = harness.load_benchmark()
    if trace:
        names = {m["name"] for m in harness.per_layer_for(bench, CELL)}
        assert set(line["metrics"]) <= names
    else:
        assert set(line["metrics"]) == {"card_sort_keys_per_s", "setup_s"}


def test_the_tagged_cell_packs_int64():
    """7 key bits and 28 tag bits at the cell's 2^28 keys: the plan the
    configuration makes packs int64, where auto detection would not tag."""
    from repro_torch.core.tagging import tag_bits
    from repro_torch.sort import SortSpec
    cfg = harness.load_config("hss_p8_2p28_skew2_tag")
    spec = SortSpec(**cfg["spec"])
    assert spec.tag is True
    b = tag_bits(spec.shards, cfg["keys"] // spec.shards)
    key_bits = (100).bit_length()    # SKEW2's keys lie in [0, 100]
    assert (key_bits, b) == (7, 28)
    assert 30 < key_bits + b <= 62   # over int32's budget, within int64's


def test_control_of_the_tagged_cell_is_not_correct():
    control = harness.load_config("hss_p8_2p28_skew2_tag")["control"]
    line, _ = tiny_run(spec=control["spec"])
    assert not line["correct"]


def test_a_wrong_unpack_is_not_correct(monkeypatch):
    """A fault planted in the tagged path's decode: one key of every
    answer off by one."""
    from repro_torch.sort.adapters import AdapterPlan
    orig = AdapterPlan.decode_batched

    def decode_batched(self, raw):
        out = orig(self, raw)
        out.shards[..., 0, 0] += 1
        return out

    monkeypatch.setattr(AdapterPlan, "decode_batched", decode_batched)
    line, _ = tiny_run()
    assert not line["correct"]
    assert line["checks"]["wrong_keys"]["value"] > 0
