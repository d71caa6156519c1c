"""Collective-cost model over the `Comm` records (counterpart of
repro.analysis.comms).

HSS's claim is stated in rounds x bytes. The reference reads both from a
traced jaxpr before compilation; the port runs eagerly, so it reads them
from the records `Comm` keeps of the calls as they run
(`repro_torch.parallel.comm.recording`). `analyze(fn, *args)` runs the
program once and folds the records into the reference's table:

  * a call outside every splitter round is one `Collective` with trips 1
    and path ();
  * the calls of a loop of rounds fold into one `Collective` per call of
    the round body, in the order of the loop's first round, with trips =
    the number of rounds that made that call and path ("rounds",). The
    reference counts its scan length instead (every round, converged or
    not), so the port's trips are at most the reference's.

`operand_bytes` is the per-shard operand (the shard axis dropped), the
reference's currency: all_gather moves about (p-1)/p of its output,
all_to_all about (p-1)/p of its operand, psum about twice its operand on
a ring. `to_json` uses the reference's keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.parallel.comm import recording

__all__ = ["Collective", "CommsReport", "analyze", "analyze_events",
           "fold", "trace"]

ROUND_PATH = ("rounds",)


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective call, or one call of a round body with its trips."""

    primitive: str                    # e.g. "all_gather"
    shape: Tuple[int, ...]            # per-shard operand shape
    dtype: str                        # operand dtype name
    operand_bytes: int                # per-shard operand bytes
    axes: Tuple[str, ...]             # the Comm axis it ran over
    trips: Optional[int]              # rounds that made it; 1 outside
    path: Tuple[str, ...]             # ("rounds",) inside a round, else ()

    @property
    def total_bytes(self) -> Optional[int]:
        """operand_bytes x trips."""
        return None if self.trips is None else self.operand_bytes * self.trips

    def describe(self) -> str:
        trips = "?" if self.trips is None else str(self.trips)
        path = "/".join(self.path) or "-"
        return (f"{self.primitive:18s} {str(self.shape):>18s} {self.dtype:>8s}"
                f" x{trips:<4s} {_fmt_bytes(self.operand_bytes):>10s}"
                f"  axes={','.join(self.axes) or '-'}  at {path}")


@dataclasses.dataclass(frozen=True)
class CommsReport:
    """All collectives of one program run, with rounds and bytes rolled
    up."""

    label: str
    collectives: Tuple[Collective, ...]

    def counts(self) -> dict:
        """Calls by primitive, a round-body call counted once (the
        reference's static count)."""
        out: dict = {}
        for c in self.collectives:
            out[c.primitive] = out.get(c.primitive, 0) + 1
        return out

    def total_rounds(self) -> Optional[int]:
        """Collective calls, round trips included."""
        return sum(c.trips for c in self.collectives)

    def total_bytes(self) -> Optional[int]:
        return sum(c.total_bytes for c in self.collectives)

    def in_round_scan(self) -> Tuple[Collective, ...]:
        """The collectives inside splitter rounds (the per-round costs)."""
        return tuple(c for c in self.collectives if c.path == ROUND_PATH)

    def render(self) -> str:
        lines = [f"collective cost report: {self.label}",
                 f"  {'primitive':18s} {'operand shape':>18s} {'dtype':>8s}"
                 f" trips {'bytes':>10s}"]
        lines += ["  " + c.describe() for c in self.collectives]
        lines.append(f"  total: {len(self.collectives)} collectives, "
                     f"{self.total_rounds()} calls, "
                     f"{_fmt_bytes(self.total_bytes())} operand bytes")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "label": self.label,
            "counts": self.counts(),
            "total_rounds": self.total_rounds(),
            "total_bytes": self.total_bytes(),
            "collectives": [dataclasses.asdict(c) for c in self.collectives],
        }


def fold(events) -> Tuple[Collective, ...]:
    """The "call" events of a recording as Collectives: each loop of
    rounds (a run of round calls of one Comm with nondecreasing round
    numbers) folds by the call's place in its round."""
    out: list = []
    seg: dict = {}      # key -> [Collective fields, trips]; a loop of rounds
    state = {"comm": None, "j": None, "pos": 0}

    def close():
        for (_, prim, shape, dtype, axis), (nbytes, trips) in seg.items():
            out.append(Collective(prim, shape, dtype, nbytes, (axis,), trips,
                                  ROUND_PATH))
        seg.clear()
        state["comm"] = state["j"] = None

    for e in events:
        if e.kind != "call":
            continue
        r = e.record
        if r.round is None:
            close()
            out.append(Collective(r.collective, r.shape, r.dtype, r.nbytes,
                                  (r.axis,), 1, ()))
            continue
        if state["comm"] != e.comm or (state["j"] is not None
                                       and r.round < state["j"]):
            close()
            state["comm"] = e.comm
        if r.round != state["j"]:
            state["j"], state["pos"] = r.round, 0
        key = (state["pos"], r.collective, r.shape, r.dtype, r.axis)
        state["pos"] += 1
        nbytes, trips = seg.get(key, (r.nbytes, 0))
        seg[key] = (nbytes, trips + 1)
    close()
    return tuple(out)


def analyze_events(events, label: str = "<program>") -> CommsReport:
    return CommsReport(label=label, collectives=fold(events))


def trace(fn, *args: Any, **kwargs: Any):
    """Run fn(*args, **kwargs) and return (its result, the CommEvents of
    the run)."""
    with recording() as events:
        out = fn(*args, **kwargs)
    return out, list(events)


def analyze(fn, *args: Any, label: Optional[str] = None) -> CommsReport:
    """Run fn(*args) once and model its collectives."""
    _, events = trace(fn, *args)
    return analyze_events(events,
                          label=label or getattr(fn, "__name__", "<fn>"))


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):.1f}MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KiB"
    return f"{n}B"
