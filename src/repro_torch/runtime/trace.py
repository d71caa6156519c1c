"""Phase spans of the sort path, recorded only while a torch.profiler
session runs on the calling thread.

Each public front door (`sort`, `sort_batched`, `argsort`, `sort_kv`,
`semisort`, `semisort_batched`, `groupby_aggregate`, `top_k`,
`top_k_batched`) opens one root span a call, `sort`, and the path opens
its phases inside it:

  plan        the adapter plan: to_core, the key range, the duplicate
              check and the `plan.probe` copy (`sort/adapters.make_plan`)
  pack        the implicit tags packed into the keys, (key << b) | index
              (`AdapterPlan.encode`; tagged plans only)
  unpack      the tags split off again: indices, pad trimming and the
              rebase undone (`AdapterPlan.decode_batched`; tagged only)
  local_sort  the shard rows' local sort (`Partitioner.sharded_batched`;
              each stage's in `core/multistage`; top_k's shard sort)
  splitters   every splitter round and its early-exit reads (the same
              places, and `Partitioner.partition_sorted_batched`)
  exchange    the exchange, its merge included (the same places; top_k's
              all_gather of the shards' suffixes)
  merge       the k-way merge of the received runs
              (`kernels/dispatch.merge_runs`, `merge_ragged`)
  stage1      multistage's first stage: its splitters and exchange
              (`core/multistage.two_stage_sort_batched`)
  stage2      multistage's second stage, from the fold of the stage-1
              rows to the final unfold: its splitters and exchange

A public call made inside another opens no span of its own: its phases
sit under the outer root. Retry, verify and SLO re-launches run inside
the one root, each with its own phases. A phase outside every root (a
kernel dispatched with no public call around it) records nothing. What
a call does between its phases (the upload of host keys, an untagged
encode, pad, decode outside `unpack`, semisort's heavy-hitter detection)
is the root's own time.

The switch is the profiler itself: `span` asks
`torch._C._autograd._profiler_enabled()`, which is True only on a thread
that runs a session (`torch.profiler.profile`, any activities). With no
session a span is that one check: it returns a shared do-nothing context,
records nothing, makes no CUDA event, takes no lock and enters no
`record_function`. A thread that did not start the session (the
service's executor thread, say) records no span.

A recorded span keeps its name, its id, its parent's id, its call's id
(the root's), its host start and end in ns on `time.time_ns()` (the epoch
clock kineto stamps device activity with, though its device times drift
against it by up to milliseconds), its stream time and its stream start.
On the card the stream time is the `elapsed_time` between two timing
events recorded at entry and exit, without a sync, on the stream that
was current when the root opened, so it counts the span's device work
and the stream's idle inside it (the port runs one stream, so the stream
times of nested spans add up); the stream start is the `elapsed_time`
from the root's entry event to the span's, which places the span on the
device's own clock. On the CPU both are host times. Each
span also enters `torch.profiler.record_function(name)`, so a profile
with CPU activity shows the names over the kernels they launched.

The record is in memory, the newest `MAX_SPANS` spans, and is read
through `spans()`, which resolves the events (waiting for them if the
card has not reached them). Nothing is written to a file.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

#: Spans kept in memory; past this the oldest are dropped. A 2^28-key
#: HSS call records 6 (8 when tagged, 11 two-stage), so the bound holds
#: some six thousand calls.
MAX_SPANS = 65_536

_profiler_enabled = torch._C._autograd._profiler_enabled

_record: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The context of a span while no profiler runs: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "call", "stream", "start_ns",
                 "end_ns", "_events", "_origin", "_times", "_rf")

    def __init__(self, name: str, stream):
        self.name = name
        self.stream = stream        # the CUDA stream timed; None: the host
        self._events = None
        self._origin = None         # the root's entry: its event, or its ns
        self._times = None          # (stream_ms, stream_start_ms), resolved

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:   # the port runs one stream: a child times its root's
            parent = stack[-1]
            self.parent, self.call = parent.id, parent.call
            self.stream, self._origin = parent.stream, parent._origin
        else:
            self.parent, self.call = None, self.id
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        if self.stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self.stream)
        if not stack:
            self._origin = (self.start_ns if self._events is None
                            else self._events[0])
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self.stream)
        self.end_ns = time.time_ns()
        _stack().pop()
        self._rf.__exit__(*exc)
        self._rf = None
        _record.append(self)
        return False

    def times(self) -> tuple[float, float]:
        """(stream_ms, stream_start_ms), resolved once; the events and the
        root's entry are let go then."""
        if self._times is None:
            if self._events is None:
                self._times = ((self.end_ns - self.start_ns) / 1e6,
                               (self.start_ns - self._origin) / 1e6)
            else:
                start, end = self._events
                end.synchronize()
                self._times = (start.elapsed_time(end),
                               self._origin.elapsed_time(start))
                self._events = None
            self._origin = None
        return self._times


def _cuda_stream(device):
    """The stream a root on `device` is timed on: the device's current
    stream; None for the CPU (and for a CUDA device with no card, which
    the call itself refuses)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.current_stream(device)


def span(name: str):
    """A phase span, the child of the span open on this thread; outside
    every root (a kernel dispatched with no public call around it) it
    records nothing."""
    if not _profiler_enabled() or not _stack():
        return _OFF
    return _Span(name, None)


def root(name: str, device):
    """The span of one public call on `device`; a call made inside an open
    span opens none."""
    if not _profiler_enabled() or _stack():
        return _OFF
    return _Span(name, _cuda_stream(device))


def spans() -> list[dict]:
    """Every span recorded, in the order they closed, as plain dicts:
    name, id, parent (None for a root), call (the root's id), start_ns,
    end_ns (host, `time.time_ns()`), stream_ms and stream_start_ms (the
    span's entry on its stream, ms after its root's). Reading resolves
    the stream times, waiting for the card to reach each span's end."""
    out = []
    for s in _record.copy():
        stream_ms, stream_start_ms = s.times()
        out.append({"name": s.name, "id": s.id, "parent": s.parent,
                    "call": s.call, "start_ns": s.start_ns,
                    "end_ns": s.end_ns, "stream_ms": stream_ms,
                    "stream_start_ms": stream_start_ms})
    return out


def clear() -> None:
    """Drop every recorded span."""
    _record.clear()
