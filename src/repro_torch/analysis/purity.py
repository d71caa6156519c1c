"""Host-sync and retrace lints for the front doors (counterpart of
repro.analysis.purity).

Two failure modes wreck serving throughput without breaking any
correctness test:

* a device-to-host read (`int()`, `bool()`, `.cpu()`, a boolean mask, a
  blocking upload) stalls the Python thread until the card drains its
  stream;
* a launch whose cache key varies across identical calls, or that
  bypasses the cache, counts a new trace every time.

Host syncs. The port keeps a few on purpose, each inside
`sync_site(name)` (repro_torch.runtime.syncs lists them).
`count_host_syncs(fn, device=...)` runs a front door and returns the
entries of each site. On the card it runs under
`torch.cuda.set_sync_debug_mode("error")`, which the sites lift for their
own syncs, so any sync outside them raises `HostSyncViolation`. On the
CPU the mode is inert and the check is structural: the counters still
count, and the same pinned numbers hold.

`pinned_syncs(door, events, batch=...)` gives each front door's count as
a formula of its run (the CommEvents `count_host_syncs` records):

  door               plan.probe  hss.early_exit  other sites
  sort               A           R               gather 1
  sort_batched (B)   A           R               gather B
  argsort            A           R               gather 1
  sort_kv            A           R               gather 2
  semisort           A           R               gather 1, semisort.host 2
  top_k              0           0               semisort.host 1
  sort, "retry"      A           R               retry.overflow A, gather 1
  sort, verify=full  A           R               audit.copy A, imbalance 1,
                                                 gather 1

A is the launches (one plan each), and R = the sum over launches of
min(rounds that ran + 1, k): HSS reads its early exit once a round until
it fires. "gather" is the caller's `gather()` (or the gathers argsort and
sort_kv make), "semisort.host" the heavy keys and counts (or top_k's
keys) copied to the host.

Retraces. `audit_retrace(fn)` reads `repro_torch.sort.driver.exec_cache`
around a warm repeat: it must add no trace and at least one hit.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, NamedTuple

from repro_torch.parallel.comm import recording
from repro_torch.runtime import syncs
from repro_torch.runtime.syncs import sync_site

__all__ = [
    "HostSyncViolation",
    "RetraceViolation",
    "SyncAudit",
    "sync_site",
    "count_host_syncs",
    "early_exit_reads",
    "pinned_syncs",
    "check_pinned",
    "audit_retrace",
    "semisort_deferred",
    "DOORS",
]

DOORS = ("sort", "sort_batched", "argsort", "sort_kv", "semisort", "top_k",
         "sort[retry]", "sort[verify=full]")


class HostSyncViolation(AssertionError):
    """A host sync outside every documented site, or a count that no
    pinned formula explains."""


class RetraceViolation(AssertionError):
    """A warm-cache repeat call counted a new trace, or no hit."""


class SyncAudit(NamedTuple):
    result: Any
    syncs: Counter        # entries of each documented site
    events: list          # the run's CommEvents


def count_host_syncs(fn: Callable, *args: Any, device="cuda",
                     **kwargs: Any) -> SyncAudit:
    """Run fn(*args, **kwargs) and count the documented syncs it entered.
    `device` is where fn's work runs: on a CUDA device (the default; with
    no card it raises) every other sync raises HostSyncViolation, and
    ``device="cpu"`` gives the structural check."""
    from repro_torch.sort.api import resolve_device

    dev = resolve_device(device)
    before = syncs.snapshot()
    with recording() as events:
        if dev.type == "cuda":
            try:
                with syncs.guarded():
                    out = fn(*args, **kwargs)
            except RuntimeError as e:
                if "synchronizing" not in str(e):
                    raise
                raise HostSyncViolation(
                    f"host sync outside every documented site: {e}") from e
        else:
            out = fn(*args, **kwargs)
    after = syncs.snapshot()
    after.subtract(before)
    return SyncAudit(out, +after, list(events))


def early_exit_reads(events) -> int:
    """R: for each launch, the rounds it entered up to and including the
    one whose early exit fired (every round entered when none fired)."""
    reads: dict = {}
    fired: set = set()
    for e in events:
        if e.comm in fired:
            continue
        if e.kind == "round":
            reads[e.comm] = reads.get(e.comm, 0) + 1
        elif e.kind == "exit":
            fired.add(e.comm)
    return sum(reads.values())


def pinned_syncs(door: str, events, batch: int = 1) -> Counter:
    """The documented syncs `door` must enter, from its run's events (see
    the module's table)."""
    if door not in DOORS:
        raise ValueError(f"no pinned formula for {door!r}; known: {DOORS}")
    if door == "top_k":
        return Counter({"semisort.host": 1})
    launches = len({e.comm for e in events})
    out = Counter({"plan.probe": launches,
                   "hss.early_exit": early_exit_reads(events),
                   "gather": 1})
    if door == "sort_batched":
        out["gather"] = batch
    elif door == "sort_kv":
        out["gather"] = 2
    elif door == "semisort":
        out["semisort.host"] = 2
    elif door == "sort[retry]":
        out["retry.overflow"] = launches
    elif door == "sort[verify=full]":
        out.update({"audit.copy": launches, "imbalance": 1})
    return +out


def check_pinned(door: str, audit: SyncAudit, batch: int = 1) -> Counter:
    """Raise HostSyncViolation unless the audit's counts equal the pinned
    formula; returns the counts."""
    want = pinned_syncs(door, audit.events, batch=batch)
    if audit.syncs != want:
        raise HostSyncViolation(
            f"{door}: host syncs {dict(audit.syncs)}, the pinned formula "
            f"gives {dict(want)}")
    return audit.syncs


def audit_retrace(fn: Callable, *args: Any, warmups: int = 1,
                  **kwargs: Any) -> Any:
    """Require that repeat calls hit the executable cache: ``warmups``
    calls, then one more that must add no trace and at least one hit.
    Returns the final call's result."""
    from repro_torch.sort.driver import exec_cache

    for _ in range(warmups):
        fn(*args, **kwargs)
    traces, hits = exec_cache.traces, exec_cache.hits
    out = fn(*args, **kwargs)
    d_traces = exec_cache.traces - traces
    d_hits = exec_cache.hits - hits
    if d_traces:
        raise RetraceViolation(
            f"warm repeat call re-traced ({d_traces} new trace(s)); the "
            "program is unkeyed or its cache key varies across identical "
            "calls")
    if d_hits < 1:
        raise RetraceViolation(
            "warm repeat call recorded no executable-cache hit; the "
            "program bypasses the cache entirely")
    return out


def semisort_deferred(out) -> bool:
    """Whether a semisort output still holds its heavy statistics on the
    device (nothing copied to the host yet), as the reference defers
    them (repro/analysis/lint.py:263-268)."""
    return getattr(out, "_decode", None) is not None
