"""The port's phase spans in a traced window, for the readers of the
`program_span` metrics.

The port records a span at each phase of a sort while a torch.profiler
session runs (`repro_torch.runtime.trace`: `sort` a public call, and
inside it `plan`, `local_sort`, `splitters`, `exchange` and, inside
`exchange`, `merge`), so a `--trace 1` run's window records them and an
untraced run does not. A reader keeps the spans whose host start lies in
the traced timeline's window and gives ms a call, over the calls that
completed in it. Each returns None where there is nothing to read: no
timeline (a run on the CPU), no completed call, a port without the
tracer, or no span of the name in the window. The idle readers put the
spans on the device trace's clock first (`place_calls`).
"""
from __future__ import annotations

import bisect


def window_spans(r) -> list[dict] | None:
    """The port's spans that started in the traced window; None where
    there is none to read."""
    if r.timeline is None or r.calls == 0:
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:    # a port without the tracer records no span
        return None
    t0, t1 = r.timeline.t0_ns, r.timeline.t1_ns
    return [s for s in trace.spans() if t0 <= s["start_ns"] <= t1] or None


def stream_ms(r, name: str) -> float | None:
    """Stream time of the spans named `name`, ms a call."""
    spans = window_spans(r)
    own = [s["stream_ms"] for s in spans or () if s["name"] == name]
    return sum(own) / r.calls if own else None


def self_ms(r, name: str) -> float | None:
    """Self time of the spans named `name`: their stream time less that
    of their children, ms a call."""
    spans = window_spans(r)
    own = {s["id"]: s["stream_ms"] for s in spans or () if s["name"] == name}
    if not own:
        return None
    children = sum(s["stream_ms"] for s in spans if s["parent"] in own)
    return (sum(own.values()) - children) / r.calls


#: How far from a root's host start the idle gap before its call is
#: looked for. kineto's device times have been seen 4.9 ms off
#: `time.time_ns()` on an H100; a call's first phase keeps the card busy
#: for longer, so its next gap lies farther.
SEARCH_NS = 5_000_000
#: How far before the end of a piece of device work a placed span's entry
#: or exit may lie, and its root's entry outside the idle gap before its
#: call. Where kineto's clock holds, the two agree to 4 µs on an H100.
LEAD_NS = 20_000


def _gap_before(gaps, ends, h):
    """The longest idle gap that ends within SEARCH_NS of `h`."""
    lo = bisect.bisect_left(ends, h - SEARCH_NS)
    hi = bisect.bisect_right(ends, h + SEARCH_NS)
    return max(gaps[lo:hi], key=lambda g: g[1] - g[0], default=None)


def _before_end(work, starts, t):
    """How far `t` lies before the end of the piece of device work it
    falls in (sorted, on one stream); 0 between two."""
    i = bisect.bisect_left(starts, t) - 1
    if i < 0 or t >= work[i][1]:
        return 0
    return work[i][1] - t


def place_calls(r, spans) -> list[dict]:
    """Each call of the window on the device trace's clock.

    kineto's device times drift and jump against `time.time_ns()` by
    milliseconds within a window. The harness synchronises after each
    call, and a call that leaves its result on the card returns with its
    last work queued: its root's exit event runs as that work ends, where
    the idle gap before the next call starts (the longest gap within
    SEARCH_NS of the next root's host start). That fixes the root on the
    device's clock, and each span of the call follows from its stream
    start and stream time. The check, as the port runs one stream: a
    timing event runs in idle time or as the work before it ends, never
    inside a piece of work, so each span's entry and exit must lie in
    idle time or within LEAD_NS of the end of the work it falls in, and
    the root's entry, which ran on an idle card before the call's first
    work, in the gap before its call. A call that fails (its device times
    moved inside the call, or it ended on the host) is not placed; nor is
    the window's last call, which has no next root.

    -> per root of the window but the last: {"root", "gap" (before the
    call, or None), "entry_ns" (the root's entry on the device's clock),
    "spans" ([(name, start_ns, end_ns)] on that clock), "placed"}.
    """
    tl = r.timeline
    gaps = [g for g in tl.gaps() if g[1] < tl.t1_ns]
    ends = [e for _, e in gaps]
    work = sorted((s, e) for _, _, s, e in tl.events)
    starts = [s for s, _ in work]
    of_call: dict = {}
    for s in spans:
        of_call.setdefault(s["call"], []).append(s)
    roots = sorted((s for s in spans if s["parent"] is None),
                   key=lambda s: s["start_ns"])
    before = [_gap_before(gaps, ends, root["start_ns"]) for root in roots]
    out = []
    for root, gap, after in zip(roots, before, before[1:]):
        entry, placed_spans, placed = None, [], False
        if gap is not None and after is not None:
            entry = after[0] - round(root["stream_ms"] * 1e6)
            for s in of_call[root["id"]]:
                start = entry + round(s["stream_start_ms"] * 1e6)
                placed_spans.append(
                    (s["name"], start, start + round(s["stream_ms"] * 1e6)))
            placed = (gap[0] - LEAD_NS <= entry <= gap[1] + LEAD_NS
                      and all(_before_end(work, starts, t) <= LEAD_NS
                              for _, a, b in placed_spans for t in (a, b)))
        out.append({"root": root, "gap": gap, "entry_ns": entry,
                    "spans": placed_spans, "placed": placed})
    return out


def idle_ms(r, name: str) -> float | None:
    """Device idle time of the traced timeline's gaps whose midpoint lies
    in a span named `name` and in none of its children, ms a placed call
    (`place_calls`). A gap goes to the innermost span open at its
    midpoint (`Timeline.idle_by_host`), which is exact for a span with no
    child. None where no call could be placed."""
    spans = window_spans(r)
    if spans is None or not any(s["name"] == name for s in spans):
        return None
    calls = [c for c in place_calls(r, spans) if c["placed"]]
    if not calls:
        return None
    placed = [s for c in calls for s in c["spans"]]
    names = {s[0] for s in placed}
    idle = dict(r.timeline.idle_by_host(placed, "outside every span",
                                        k=len(names) + 1))
    return 1e3 * idle.get(name, 0.0) / len(calls)
