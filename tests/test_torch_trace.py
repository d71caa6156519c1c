"""The sort path's phase spans (`repro_torch.runtime.trace`): recorded
only under a profiler session, one root a public call with its phases
inside, nested host intervals, one call id, a bounded record, and no
change to what a sort returns.

The file imports neither jax nor repro; its `cuda`-marked tests skip
without a card and run there with

    PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py
"""
import threading

import numpy as np
import pytest
import torch

import repro_torch.sort as tsort
from repro_torch.runtime import trace
from repro_torch.sort import SortSpec

CPU = torch.profiler.ProfilerActivity.CPU
CUDA = torch.profiler.ProfilerActivity.CUDA
N = 8 * 4096
PHASES = ["plan", "local_sort", "splitters", "exchange"]
#: A tagged plan's: the tags packed after the plan, split off at the end.
TAGGED = ["plan", "pack", "local_sort", "splitters", "exchange", "unpack"]


@pytest.fixture(autouse=True)
def _empty_record():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stream times from CUDA events")
    return "cuda"


def _keys(n=N, seed=0):
    return np.random.default_rng(seed).integers(
        0, 2 ** 30, n).astype(np.int32)


def _traced(fn, activities=(CPU,)):
    with torch.profiler.profile(activities=list(activities)):
        out = fn()
    return out, trace.spans()


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


def _roots(spans):
    return [s for s in spans if s["parent"] is None]


# -- the switch ------------------------------------------------------------

def test_gate_is_the_profiler_call():
    """The gate is torch's private call, bound once: a torch upgrade that
    renames it or stops it turning on under a session fails here."""
    assert trace._profiler_enabled is torch._C._autograd._profiler_enabled
    assert not trace._profiler_enabled()
    with torch.profiler.profile(activities=[CPU]):
        assert trace._profiler_enabled()
    assert not trace._profiler_enabled()
    with torch.autograd.profiler.profile():
        assert trace._profiler_enabled()


def test_no_session_records_nothing_and_builds_nothing(monkeypatch):
    """Off, a span is the gate check alone: the shared do-nothing context,
    no span object, no CUDA event, no record_function."""
    def refuse(*a, **k):
        raise AssertionError("built while no profiler runs")

    monkeypatch.setattr(trace, "_Span", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("plan") is trace._OFF
    assert trace.root("sort", "cpu") is trace._OFF
    out = tsort.sort(_keys(), SortSpec(device="cpu"))
    np.testing.assert_array_equal(out.gather(), np.sort(_keys()))
    assert trace.spans() == []
    assert getattr(trace._local, "stack", None) in (None, [])


def test_a_thread_without_the_session_records_nothing():
    """The gate is per thread: a sort on a thread that did not start the
    session records no span."""
    done = []

    def work():
        done.append(tsort.sort(_keys(), SortSpec(device="cpu")).gather())

    with torch.profiler.profile(activities=[CPU]):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=120)
    assert not t.is_alive() and len(done) == 1
    assert trace.spans() == []


# -- one call --------------------------------------------------------------

def test_one_sort_is_one_root_with_its_phases():
    x = _keys()
    _, spans = _traced(lambda: tsort.sort(x, SortSpec(device="cpu",
                                                      shards=8)))
    (root,) = _roots(spans)
    assert root["name"] == "sort" and root["call"] == root["id"]
    assert _children(spans, root) == PHASES
    (exchange,) = [s for s in spans if s["name"] == "exchange"]
    assert _children(spans, exchange) == ["merge"]
    assert len(spans) == 6
    assert {s["call"] for s in spans} == {root["id"]}


def test_each_child_lies_inside_its_parent():
    _, spans = _traced(lambda: tsort.sort(_keys(), SortSpec(device="cpu")))
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"]
            assert s["end_ns"] <= parent["end_ns"]
    # on the CPU the stream time is the host duration, and the stream
    # start the host time since the root's start
    root = _roots(spans)[0]
    for s in spans:
        assert s["stream_ms"] == pytest.approx(
            (s["end_ns"] - s["start_ns"]) / 1e6)
        assert s["stream_start_ms"] == pytest.approx(
            (s["start_ns"] - root["start_ns"]) / 1e6)
    assert root["stream_start_ms"] == 0
    # siblings do not overlap, in the order they ran
    kids = sorted((s for s in spans if s["parent"] == root["id"]),
                  key=lambda s: s["start_ns"])
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(kids, kids[1:]))


def _presorted():
    return np.arange(N, dtype=np.int32)


CALLS = {
    "sort_batched": (lambda: tsort.sort_batched(
        np.stack([_keys(seed=1), _keys(seed=2)]), SortSpec(device="cpu")),
        1),
    "sort_batched_list": (lambda: tsort.sort_batched(
        [_keys(seed=1), _keys(N // 2, seed=2), _keys(seed=3)],
        SortSpec(device="cpu")), 2),
    "sort_batch_spec": (lambda: tsort.sort(
        np.stack([_keys(seed=1), _keys(seed=2)]),
        SortSpec(device="cpu", batch=True)), 1),
    "retry": (lambda: tsort.sort(
        _presorted(), SortSpec(device="cpu", on_overflow="retry")), 3),
    "argsort": (lambda: tsort.argsort(_keys(), SortSpec(device="cpu")), 1),
    "sort_kv": (lambda: tsort.sort_kv(
        _keys(), np.arange(N), SortSpec(device="cpu")), 1),
    "verify_cheap": (lambda: tsort.sort(
        _keys(), SortSpec(device="cpu", verify="cheap")), 1),
}


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_every_attempt_of_a_public_call_is_under_one_root(kind):
    """Batches, a length-bucketed list, a nested public call, the retry
    policy's attempts and the permutation doors: one root each, and
    every launch's phases under it."""
    fn, launches = CALLS[kind]
    out, spans = _traced(fn)
    (root,) = _roots(spans)
    assert root["name"] == "sort"
    assert {s["call"] for s in spans} == {root["id"]}
    # the permutation doors always tag: pack and unpack a launch
    phases = TAGGED if kind in ("argsort", "sort_kv") else PHASES
    assert _children(spans, root) == phases * launches
    if kind == "retry":
        assert out.recovery.attempts == launches > 1


def test_traced_output_is_bit_identical():
    x = _keys(seed=7)
    spec = SortSpec(device="cpu")
    plain = tsort.sort(x, spec)
    traced, spans = _traced(lambda: tsort.sort(x, spec))
    assert spans
    for a, b in ((plain.shards, traced.shards), (plain.counts, traced.counts),
                 (plain.splitter_keys, traced.splitter_keys)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(plain.gather(), traced.gather())


SMALL = np.random.default_rng(5).integers(0, 50, N).astype(np.int32)

OTHER_DOORS = {
    "semisort": (lambda: tsort.semisort(SMALL, spec=SortSpec(device="cpu")),
                 {"sort": PHASES, "exchange": ["merge"]}),
    "semisort_batched": (lambda: tsort.semisort_batched(
        np.stack([SMALL, SMALL[::-1]]), SortSpec(device="cpu")),
        {"sort": PHASES, "exchange": ["merge"]}),
    "groupby_count": (lambda: tsort.groupby_aggregate(
        SMALL, op="count", spec=SortSpec(device="cpu")),
        {"sort": PHASES, "exchange": ["merge"]}),
    "groupby_sum": (lambda: tsort.groupby_aggregate(
        SMALL, np.arange(N), op="sum", spec=SortSpec(device="cpu")),
        {"sort": TAGGED, "exchange": ["merge"]}),   # sort_kv: tagged
    "top_k": (lambda: tsort.top_k(_keys(), 10, SortSpec(device="cpu")),
              {"sort": ["local_sort", "exchange"], "exchange": ["merge"]}),
    "top_k_batched": (lambda: tsort.top_k_batched(
        np.stack([_keys(seed=1), _keys(seed=2)]), 10, SortSpec(device="cpu")),
        {"sort": ["local_sort", "exchange"], "exchange": ["merge"]}),
    "multistage": (lambda: tsort.sort(
        _keys(), SortSpec(device="cpu", algorithm="multistage")),
        {"sort": ["plan", "local_sort", "stage1", "stage2"],
         "stage1": ["splitters", "exchange"],
         "stage2": ["splitters", "exchange"], "exchange": ["merge"]}),
}


@pytest.mark.parametrize("kind", sorted(OTHER_DOORS))
def test_the_other_front_doors_open_one_root(kind):
    """semisort, groupby, top_k and the two-stage sort: one root a call,
    its phases under it (the two-stage sort's splitters and exchanges
    under its `stage1` and `stage2`) and every merge inside an
    exchange."""
    fn, tree = OTHER_DOORS[kind]
    _, spans = _traced(fn)
    (root,) = _roots(spans)
    assert root["name"] == "sort"
    assert {s["call"] for s in spans} == {root["id"]}
    assert _children(spans, root) == tree["sort"]
    for name, kids in tree.items():
        for parent in (s for s in spans if s["name"] == name):
            assert _children(spans, parent) == kids


TAG_PLANS = {
    # UNIF keys (30 bits) with auto detection: no tag fits int32
    "untagged": (_keys(), SortSpec(device="cpu", shards=8), False),
    "tag_false": (_keys(seed=3), SortSpec(device="cpu", shards=8,
                                          tag=False), False),
    # duplicated keys, 6 + 12 bits: auto tags into int32
    "auto_int32": (SMALL, SortSpec(device="cpu", shards=8), True),
    # 30 + 12 bits: tag=True packs int64
    "tag_int64": (_keys(), SortSpec(device="cpu", shards=8, tag=True), True),
}


@pytest.mark.parametrize("plan", sorted(TAG_PLANS))
def test_pack_and_unpack_open_only_on_tagged_plans(plan):
    """`pack` and `unpack` are children of the root, once a launch, the
    pack before the local sort and the unpack after the exchange; an
    untagged plan opens neither, and its tree is as before."""
    x, spec, tagged = TAG_PLANS[plan]
    out, spans = _traced(lambda: tsort.sort(x, spec))
    (root,) = _roots(spans)
    assert _children(spans, root) == (TAGGED if tagged else PHASES)
    assert (out.indices is not None) == tagged
    np.testing.assert_array_equal(out.gather(), np.sort(x))


# -- spans on their own ----------------------------------------------------

def test_a_span_outside_a_root_records_nothing():
    """A phase with no public call around it (a kernel dispatched on its
    own) records nothing; a public call inside another opens no root."""
    with torch.profiler.profile(activities=[CPU]):
        assert trace.span("merge") is trace._OFF
        with trace.span("merge"):
            pass
        with trace.root("sort", "cpu"):
            with trace.root("sort", "cpu"):   # a nested public call
                with trace.span("plan"):
                    pass
    plan, root = trace.spans()
    assert plan["parent"] == root["id"] == plan["call"]
    assert root["parent"] is None and root["name"] == "sort"


def test_a_span_that_raises_is_recorded_and_closed():
    with torch.profiler.profile(activities=[CPU]):
        with pytest.raises(ValueError, match="empty"):
            tsort.sort(np.zeros(0, np.int32), SortSpec(device="cpu"))
    (root,) = trace.spans()
    assert root["name"] == "sort"
    assert trace._local.stack == []


def test_the_record_stays_at_its_bound():
    assert trace._record.maxlen == trace.MAX_SPANS == 65_536
    extra = 3
    with torch.profiler.profile(activities=[CPU]):
        for _ in range(trace.MAX_SPANS + extra):
            with trace.root("sort", "cpu"):
                pass
    spans = trace.spans()
    assert len(spans) == trace.MAX_SPANS
    ids = [s["id"] for s in spans]
    assert ids == list(range(ids[0], ids[0] + trace.MAX_SPANS))


def test_profile_with_cpu_activity_shows_the_names():
    with torch.profiler.profile(activities=[CPU]) as prof:
        tsort.sort(_keys(), SortSpec(device="cpu"))
    names = {e.key for e in prof.key_averages()}
    assert {"sort", "merge", *PHASES} <= names


# -- on the card -----------------------------------------------------------

@pytest.mark.cuda
def test_card_stream_times_under_a_cuda_only_session(card):
    """The benchmark's traced window runs torch.profiler with CUDA
    activity only: the gate turns on, and each span's stream time comes
    from its events, the children's adding up to at most the parent's."""
    x = torch.randint(0, 2 ** 30, (8 * 2 ** 18,), dtype=torch.int32,
                      device=card)
    spec = SortSpec(device=card)
    tsort.sort(x, spec)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[CUDA]):
        assert trace._profiler_enabled()
        out = tsort.sort(x, spec)
        torch.cuda.synchronize()
    spans = trace.spans()
    (root,) = _roots(spans)
    assert _children(spans, root) == PHASES
    assert all(s["stream_ms"] > 0 for s in spans)
    kids = sum(s["stream_ms"] for s in spans if s["parent"] == root["id"])
    assert kids <= root["stream_ms"] * 1.001
    # on the device's clock each child lies inside its parent, and the
    # root's children follow each other
    by_id = {s["id"]: s for s in spans}
    assert root["stream_start_ms"] == 0
    for s in spans:
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["stream_start_ms"] <= s["stream_start_ms"] + 1e-3
            assert (s["stream_start_ms"] + s["stream_ms"] <= parent[
                "stream_start_ms"] + parent["stream_ms"] + 1e-3)
    kids = sorted((s for s in spans if s["parent"] == root["id"]),
                  key=lambda s: s["stream_start_ms"])
    assert [s["name"] for s in kids] == PHASES
    assert all(a["stream_start_ms"] + a["stream_ms"]
               <= b["stream_start_ms"] + 1e-3 for a, b in zip(kids, kids[1:]))
    assert torch.equal(out.shards, tsort.sort(x, spec).shards)
