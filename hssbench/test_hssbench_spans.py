"""The readers of the `program_span` metrics: each on a synthetic span
record and a synthetic timeline with known gaps, None where there is
nothing to read, and the stream metrics adding up to the root's stream
time on a real traced sort on the CPU."""
import sys
import time

import numpy as np
import pytest
import torch

from hssbench import harness
from hssbench.devtrace import Timeline

US = 1000            # ns
MS = 1000 * US
CALLS = 3

#: One call's spans: (name, id offset, parent offset, stream start and
#: end in µs from the root's entry on the card).
CALL = [
    ("sort", 0, None, 0, 2900),
    ("plan", 1, 0, 100, 500),
    ("local_sort", 2, 0, 600, 1000),
    ("splitters", 3, 0, 1100, 1600),
    ("exchange", 4, 0, 1700, 2850),
    ("merge", 5, 4, 2000, 2800),
]
#: The card's work of a call (µs from the root's entry), on one stream as
#: the port's: each span that opens or closes on a busy card does so at
#: the end of a piece of work, one that opens on an idle card in a gap.
#: Idle 200 µs in `plan`, 2 × 100 in `splitters`, 150 + 50 in the root
#: between phases (the plan's drain and before the exchange) and 50 in
#: `merge`; the root's last work ends at 2,900 µs, as its exit event runs.
WORK = [(150, 200), (400, 500), (650, 1000), (1000, 1100), (1100, 1200),
        (1300, 1400), (1500, 1600), (1600, 1650), (1700, 2000), (2000, 2400),
        (2450, 2800), (2800, 2850), (2850, 2900)]
#: The calls' host starts (µs from the window's start, a warm-up call
#: before it), and where each root's entry lies on the device trace's
#: clock against its host start: kineto's device times drift against the
#: host clock.
CALL_STARTS = [-20_000, 10_000, 30_000, 45_000]
CLOCK_US = [0, 700, -1300, 40]
WINDOW = (0, 50 * MS)

EXPECTED = {
    "front.plan_ms": 0.4,
    "driver.local_sort_ms": 0.4,
    "splitters.stream_ms": 0.5,
    "exchange.merge_ms": 0.8,
    "exchange.send_ms": 1.15 - 0.8,
    "driver.self_ms": 2.9 - (0.4 + 0.4 + 0.5 + 1.15),
    "front.idle_ms": 0.2,
    "splitters.idle_ms": 0.2,
}
NEW = sorted(EXPECTED)


def synthetic_spans():
    """Three calls in the window and one warm-up call before it. The host
    times run ahead of the card's queue: only the window's bounds and
    the search for each call's first work read them."""
    spans = []
    for k, t0 in enumerate(CALL_STARTS):
        base = 10 * (k + 1)
        for name, i, parent, s, e in CALL:
            spans.append({"name": name, "id": base + i,
                          "parent": None if parent is None else base + parent,
                          "call": base, "start_ns": (t0 + s // 3) * US,
                          "end_ns": (t0 + e // 3) * US,
                          "stream_ms": (e - s) / 1e3,
                          "stream_start_ms": s / 1e3})
    return spans


def synthetic_timeline(clock_us=CLOCK_US, last_event=None):
    """The card's work of each call of the window, placed at its host
    start plus its clock offset, and idle between calls. `last_event`
    adds work of that many µs after each root's end (a copy to the host
    outside the call)."""
    events = []
    for t0, off in zip(CALL_STARTS[1:], clock_us[1:]):
        entry = t0 + off
        events += [("k", "kernel", (entry + s) * US, (entry + e) * US)
                   for s, e in WORK]
        if last_event:
            events.append(("Memcpy DtoH", "memcpy_dtoh", (entry + 2900) * US,
                           (entry + 2900 + last_event) * US))
    return Timeline(events, *WINDOW)


@pytest.fixture
def record(monkeypatch):
    from repro_torch.runtime import trace
    spans = synthetic_spans()
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return spans


def reading(timeline="synthetic", calls=CALLS):
    tl = synthetic_timeline() if timeline == "synthetic" else timeline
    return harness.Reading(calls, calls * 8, {"syncs": {}, "launches": {}},
                           tl)


def read(metric, r):
    return harness.load_reader(metric + ".card")(r)


def test_the_timeline_has_the_gaps():
    idle = (200 + 2 * 100 + 150 + 50 + 50) * US * (len(CALL_STARTS) - 1)
    busy = (2900 - 150) * US * (len(CALL_STARTS) - 1) - idle
    tl = synthetic_timeline()
    assert tl.busy_s() == pytest.approx(busy / 1e9)


@pytest.mark.parametrize("metric", NEW)
def test_reader_on_a_synthetic_record(metric, record):
    assert read(metric, reading()) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", NEW)
def test_reader_without_a_timeline_is_none(metric, record):
    assert read(metric, reading(timeline=None)) is None


@pytest.mark.parametrize("metric", NEW)
def test_reader_without_spans_is_none(metric, monkeypatch):
    from repro_torch.runtime import trace
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert read(metric, reading()) is None


@pytest.mark.parametrize("metric", NEW)
def test_reader_without_a_call_is_none(metric, record):
    assert read(metric, reading(calls=0)) is None


@pytest.mark.parametrize("metric", NEW)
def test_reader_of_a_port_without_the_tracer_is_none(metric, record,
                                                    monkeypatch):
    """The parent commit's port has no `runtime.trace`: the reader
    returns None and does not raise."""
    import repro_torch.runtime as runtime
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    monkeypatch.delattr(runtime, "trace", raising=False)
    assert read(metric, reading()) is None


def test_spans_outside_the_window_are_left_out(record):
    """The warm-up call before the window is not counted; a window that
    holds only one call reads that call alone."""
    late = Timeline([("k", "kernel", 40 * MS, 50 * MS)], 40 * MS, 50 * MS)
    assert read("front.plan_ms", reading(late, calls=1)) == \
        pytest.approx(0.4)


@pytest.mark.parametrize("clock_us", [
    [0, 0, 0, 0], [0, 3000, -3000, 0], [0, -40, 2500, -4000]])
@pytest.mark.parametrize("metric", ["front.idle_ms", "splitters.idle_ms"])
def test_idle_readers_hold_whatever_the_clock_offset(metric, clock_us,
                                                     monkeypatch):
    """Each call is placed on the device's clock by its root's end, so
    the idle readers read the same wherever kineto's clock lies against
    the host's, and however it drifts from call to call."""
    from repro_torch.runtime import trace
    spans = synthetic_spans()
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    r = reading(synthetic_timeline(clock_us))
    assert read(metric, r) == pytest.approx(EXPECTED[metric])


def test_each_placed_root_lies_in_the_gap_before_its_call(record):
    from hssbench.spans import place_calls, window_spans
    r = reading()
    calls = place_calls(r, window_spans(r))
    assert [c["placed"] for c in calls] == [True, True]   # the last: no next
    for c, t0, off in zip(calls, CALL_STARTS[1:], CLOCK_US[1:]):
        assert c["entry_ns"] == (t0 + off) * US
        assert c["gap"][1] == (t0 + off + WORK[0][0]) * US
        plan = [sp for sp in c["spans"] if sp[0] == "plan"]
        assert plan == [("plan", (t0 + off + 100) * US, (t0 + off + 500) * US)]


@pytest.mark.parametrize("fault", ["root", "inside_work"])
def test_a_call_whose_clock_jumps_is_not_placed(fault, monkeypatch):
    """A call whose device times move against its stream times inside
    the call is left out, and the idle readers count the placed calls
    alone: its root's stream time 2 ms short puts its entry after its own
    first work; a span's entry 150 µs off puts it inside a piece of work,
    where no timing event can run on the port's one stream."""
    from hssbench.spans import place_calls, window_spans
    from repro_torch.runtime import trace
    spans = synthetic_spans()
    for sp in spans:
        if sp["call"] != 20:
            continue
        if fault == "root" and sp["parent"] is None:
            sp["stream_ms"] -= 2.0
        if fault == "inside_work" and sp["name"] == "local_sort":
            sp["stream_start_ms"] += 0.150
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    r = reading()
    assert [c["placed"] for c in place_calls(r, window_spans(r))] == \
        [False, True]
    assert read("front.idle_ms", r) == pytest.approx(EXPECTED["front.idle_ms"])


@pytest.mark.parametrize("metric", ["front.idle_ms", "splitters.idle_ms"])
def test_a_call_that_ends_on_the_host_is_not_placed(metric, record):
    """Work after the root's end (a copy to the host outside the call, as
    in the host cell) leaves no root placed: the idle readers read None,
    the stream readers still read."""
    r = reading(synthetic_timeline(last_event=500))
    assert read(metric, r) is None
    assert read("front.plan_ms", r) == pytest.approx(EXPECTED["front.plan_ms"])


def test_both_suffixes_share_one_reader():
    for metric in NEW:
        assert harness.reader_path(metric + ".card") == \
            harness.reader_path(metric + ".host")


def test_the_stream_metrics_add_up_to_the_root_on_a_traced_sort():
    """A real traced sort on the CPU, under a timeline that covers it:
    the six stream metrics add up to the root's stream time a call."""
    from repro_torch.runtime import trace
    from repro_torch.sort import SortSpec, sort
    x = np.random.default_rng(3).integers(0, 2 ** 30, 8 * 2048,
                                          dtype=np.int32)
    trace.clear()
    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            sort(x, SortSpec(device="cpu"))
    t1 = time.time_ns()
    r = harness.Reading(2, 2 * x.size, {}, Timeline(
        [("k", "kernel", t0, t1)], t0, t1))
    stream = ["front.plan_ms", "driver.local_sort_ms", "driver.self_ms",
              "splitters.stream_ms", "exchange.send_ms", "exchange.merge_ms"]
    values = {m: read(m, r) for m in stream}
    assert all(v is not None and v >= 0 for v in values.values()), values
    roots = [s["stream_ms"] for s in trace.spans() if s["parent"] is None]
    assert len(roots) == 2
    assert sum(values.values()) == pytest.approx(sum(roots) / 2)
    # no gap in the timeline: no call can be placed, so no idle is read
    assert read("front.idle_ms", r) is None
    trace.clear()
