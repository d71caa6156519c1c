"""The documented host syncs of the sort paths, counted where they happen.

A device-to-host read stalls the Python thread until the card has drained
its stream. The port keeps a few on purpose, each wrapped in
`sync_site(name)`:

  plan.probe        the adapter plan's one copy of the key range (and of
                    the duplicate flag, when tagging is auto-detected)
  hss.early_exit    HSS's early exit, once a round until it fires
  retry.overflow    the retry policy's overflow counter, once a launch
  audit.copy        the verified sort's audit vector, once a launch
  imbalance         the shard loads behind achieved_imbalance, once an
                    output
  ragged.branch     the ragged merge's branch, once a merge
  gather            `masked_concat`, once a gathered output
  semisort.host     a grouping result copied to the host (semisort's
                    heavy stats, top_k's keys)

`sync_site` adds one to its count on every entry. While
`repro_torch.analysis.purity.count_host_syncs` holds the card under
`torch.cuda.set_sync_debug_mode("error")`, a site lets its own syncs
through and restores the mode on leaving, so any other sync raises. The
module imports nothing of the sort paths, which import it.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch

SITES = ("plan.probe", "hss.early_exit", "retry.overflow", "audit.copy",
         "imbalance", "ragged.branch", "gather", "semisort.host")

#: Entries of each site since the last `reset()`.
counts: Counter = Counter()

_lock = threading.Lock()
_guard = {"on": False}    # set while an audit holds the card in "error"


def reset():
    with _lock:
        counts.clear()


def snapshot() -> Counter:
    with _lock:
        return Counter(counts)


@contextlib.contextmanager
def sync_site(name: str):
    """One entry of the documented sync site `name`."""
    if name not in SITES:
        raise ValueError(f"undocumented sync site {name!r}; known: {SITES}")
    with _lock:
        counts[name] += 1
    if not _guard["on"]:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("error")


@contextlib.contextmanager
def guarded():
    """Hold the card under `set_sync_debug_mode("error")`: a sync outside
    every `sync_site` raises RuntimeError. Work already queued is drained
    first, so no earlier call's sync lands inside."""
    torch.cuda.synchronize()
    _guard["on"] = True
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        _guard["on"] = False


def queues_upload(x: torch.Tensor, device) -> bool:
    """Whether moving `x` to `device` may be queued on the stream with no
    host sync: an upload to the card from pageable host memory, which the
    copy stages before it returns. A copy to the host is read as soon as
    it returns, and a pinned source is read by the card later, after the
    caller may have overwritten it: both stay blocking. `device` None
    leaves `x` where it is."""
    return (device is not None and torch.device(device).type == "cuda"
            and x.device.type == "cpu" and not x.is_pinned())


def move(x: torch.Tensor, device) -> torch.Tensor:
    """`x` on `device`; an upload from pageable memory is queued (see
    `queues_upload`), where a blocking copy would first wait for the
    stream to drain."""
    return x.to(device, non_blocking=queues_upload(x, device))


def to_device(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A host constant (a number, a list, a NumPy array) or a tensor, as
    `dtype` on `device`, through `move`: an upload of a host constant
    makes no host sync."""
    return move(torch.as_tensor(values, dtype=dtype), device)
