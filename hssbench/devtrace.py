"""The device timeline of a traced window, from torch.profiler (CUDA
activity only, so no host operator is recorded), and the reductions the
per-layer metrics and the breakdown read from it.

Device events and the harness's host spans are both on the epoch clock
in nanoseconds (`time.time_ns()`; kineto stamps device activity on it).
"""
from __future__ import annotations

import bisect

KINDS = ("kernel", "memcpy_htod", "memcpy_dtoh", "memcpy_other", "memset")


def kind_of(name: str) -> str | None:
    """An event's kind by its name; None for what is no device work
    (synchronisation markers)."""
    if "Sync" in name:
        return None
    if name.startswith("Memcpy HtoD"):
        return "memcpy_htod"
    if name.startswith("Memcpy DtoH"):
        return "memcpy_dtoh"
    if name.startswith("Memcpy"):
        return "memcpy_other"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class Capture:
    """torch.profiler around a window, CUDA activity only."""

    def __init__(self):
        import torch
        self._torch = torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> list[tuple]:
        """-> [(name, kind, start_ns, end_ns)] of every device event."""
        torch = self._torch
        torch.cuda.synchronize()
        self._prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            kind = kind_of(e.name())
            if kind is None:
                continue
            start = e.start_ns()
            events.append((e.name(), kind, start, start + e.duration_ns()))
        events.sort(key=lambda ev: ev[2])
        return events


class Timeline:
    """Device events clipped to the window [t0_ns, t1_ns]."""

    def __init__(self, events, t0_ns: int, t1_ns: int):
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.captured = len(events)
        self.first_ms = (min(ev[2] for ev in events) - t0_ns) / 1e6 \
            if events else None
        self.last_ms = (max(ev[3] for ev in events) - t1_ns) / 1e6 \
            if events else None
        self.events = [(n, k, max(s, t0_ns), min(e, t1_ns))
                       for n, k, s, e in events if e > t0_ns and s < t1_ns]

    def summary(self) -> dict:
        """How the capture lines up with the window: events captured and
        kept, and the first and last event against the window's ends
        (ms; the first is negative when work of the set-up was caught)."""
        return {"captured": self.captured, "in_window": len(self.events),
                "first_vs_t0_ms": self.first_ms,
                "last_vs_t1_ms": self.last_ms,
                "kernels": self.count("kernel"),
                "htod": self.count("memcpy_htod"),
                "dtoh": self.count("memcpy_dtoh")}

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def seconds(self, kind: str) -> float:
        """Summed device time of one kind of event."""
        return sum(e - s for _, k, s, e in self.events if k == kind) / 1e9

    def count(self, kind: str) -> int:
        return sum(1 for _, k, _s, _e in self.events if k == kind)

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of all events, as sorted disjoint intervals."""
        merged: list[list[int]] = []
        for _, _, s, e in sorted(self.events, key=lambda ev: ev[2]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        """Idle intervals of the window, between and around busy ones."""
        out, t = [], self.t0_ns
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.t1_ns:
            out.append((t, self.t1_ns))
        return out

    def top_ops(self, k: int = 10) -> list[list]:
        """[[name, seconds]] of the `k` device operations that took most
        time, summed by name."""
        total: dict[str, int] = {}
        for n, _, s, e in self.events:
            total[n[:120]] = total.get(n[:120], 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: kv[1], reverse=True)[:k]
        return [[n, ns / 1e9] for n, ns in top]

    def idle_by_host(self, spans, idle_name: str, k: int = 10) -> list[list]:
        """[[host activity, seconds]]: the idle time of the window summed
        by what the harness was doing at each gap's midpoint (the newest
        open span), longest first, at most `k` entries."""
        spans = sorted(spans, key=lambda sp: sp[1])
        starts = [sp[1] for sp in spans]
        # reach[i]: the span of spans[:i + 1] that ends last
        reach, best = [], None
        for sp in spans:
            if best is None or sp[2] > best[2]:
                best = sp
            reach.append(best)
        total: dict[str, int] = {}
        for s, e in self.gaps():
            mid = (s + e) // 2
            name = idle_name
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0:
                if spans[i][2] > mid:
                    name = spans[i][0]
                elif reach[i][2] > mid:
                    name = reach[i][0]
            total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: kv[1], reverse=True)[:k]
        return [[n, ns / 1e9] for n, ns in top]
