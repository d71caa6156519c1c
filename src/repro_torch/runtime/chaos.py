"""Deterministic fault injection for the sort pipeline (counterpart of
repro.runtime.chaos; DESIGN.md Sec. 8).

The port's own copy: stdlib and numpy, the same counters and the same
semantics. A `FaultPlan` describes a reproducible set of faults;
`activate(plan)` arms it process-wide for the duration of a `with` block.
Production code consults this module at its seams and pays nothing when
no plan is active:

  * `ExchangeConfig.pair_cap` calls `clamp_pair_cap()`, so a plan can
    shrink the dense exchange's per-(src, dst) capacity and force real
    send-side overflow (what `SortSpec.on_overflow` recovers from).
  * `repro_torch.sort.api` calls `corrupt_now()` once per audited launch,
    so a plan can flip a bit of the output on the device between the sort
    pipeline and its audit: silent corruption that only
    `SortSpec(verify=...)` catches.
  * `on_dispatch(xs)` is the serving layer's seam (stragglers, crashes,
    executor death, poison requests): `repro_torch.serve.service` calls
    it at the top of every batched and per-request dispatch.

    from repro_torch.runtime import chaos
    plan = chaos.FaultPlan(clamp_pair_cap=8, corrupt_at=(0,))
    with chaos.activate(plan):
        ...                     # sorts overflow, the first audit fails
    chaos.stats()               # what fired
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np


class InjectedFault(RuntimeError):
    """A fault raised on purpose by an active FaultPlan."""


class ExecutorDeath(BaseException):
    """Simulated dispatch-thread death. Deliberately NOT an Exception:
    ordinary `except Exception` recovery must not swallow it."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One reproducible chaos scenario.

    clamp_pair_cap    clamp the dense exchange's per-(src, dst) capacity
                      to this many keys (before `capacity_scale`), forcing
                      real send-side overflow. None = no clamp.
    straggler_at      dispatch indices that sleep `straggler_delay_s`.
    straggler_delay_s seconds of injected delay per straggler dispatch.
    crash_at          dispatch indices that raise InjectedFault.
    die_at            dispatch indices that raise ExecutorDeath.
    poison_key        any dispatched batch containing this key value
                      raises InjectedFault.
    corrupt_at        audited-launch indices (True = every launch) at
                      which the audit layer (repro_torch.sort.verify)
                      XORs `corrupt_bit` into one output key on the
                      device; consumed by `corrupt_now()` once per audited
                      launch.
    corrupt_key       optional row filter for `corrupt_at`: only rows
                      whose encoded keys contain this value are flipped.
                      None flips every row of the armed launch.
    corrupt_bit       which bit the injected flip targets.
    """

    clamp_pair_cap: int | None = None
    straggler_at: tuple = ()
    straggler_delay_s: float = 0.0
    crash_at: tuple = ()
    die_at: tuple = ()
    poison_key: int | float | None = None
    corrupt_at: tuple | bool = ()
    corrupt_key: int | float | None = None
    corrupt_bit: int = 12


class _ActivePlan:
    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.lock = threading.Lock()
        self.dispatches = 0
        self.corrupt_launches = 0
        self.injected: dict = {"straggler": 0, "crash": 0, "death": 0,
                               "poison": 0, "clamp_traces": 0, "corrupt": 0}


_lock = threading.Lock()
_active: _ActivePlan | None = None


@contextlib.contextmanager
def activate(plan: FaultPlan):
    """Arm `plan` process-wide for the duration of the with-block. Plans
    do not nest."""
    global _active
    with _lock:
        if _active is not None:
            raise RuntimeError("a FaultPlan is already active")
        state = _ActivePlan(plan)
        _active = state
    try:
        yield state
    finally:
        with _lock:
            _active = None


def active() -> FaultPlan | None:
    state = _active
    return None if state is None else state.plan


def trace_token():
    """Hashable token of the active plan's capacity clamp (None when no
    clamp is armed); counts `clamp_traces` as the reference's does. The
    front doors fold it into the keys they record in
    repro_torch.sort.driver.exec_cache, so a clamped launch is counted
    apart, and `clamp_traces` counts the same calls as the reference's."""
    state = _active
    if state is None or state.plan.clamp_pair_cap is None:
        return None
    with state.lock:
        state.injected["clamp_traces"] += 1
    return ("chaos-clamp", state.plan.clamp_pair_cap)


def corrupt_now():
    """Consume one audited-launch index against the active plan's
    `corrupt_at`. Returns `(corrupt_bit, corrupt_key)` when this launch
    carries the injected bit flip, else None. Re-launches of the overflow
    and verify policies each consume their own index, so `corrupt_at=(0,)`
    models a transient fault a retry recovers from and `corrupt_at=True`
    a persistent one."""
    state = _active
    if state is None:
        return None
    plan = state.plan
    if plan.corrupt_at is True:
        armed_always = True
    elif not plan.corrupt_at:
        return None
    else:
        armed_always = False
    with state.lock:
        i = state.corrupt_launches
        state.corrupt_launches += 1
        armed = armed_always or i in plan.corrupt_at
        if armed:
            state.injected["corrupt"] += 1
    if not armed:
        return None
    return (int(plan.corrupt_bit), plan.corrupt_key)


def clamp_pair_cap(cap: int) -> int:
    """The capacity clamp `ExchangeConfig.pair_cap` applies to its base
    capacity, before `capacity_scale`, so the retry policy's escalation can
    still out-grow it (the recovery under test)."""
    state = _active
    if state is None or state.plan.clamp_pair_cap is None:
        return cap
    return min(cap, int(state.plan.clamp_pair_cap))


def on_dispatch(xs=None) -> int:
    """The serving layer's seam at the top of every batch dispatch: applies
    the active plan's dispatch-indexed faults; returns the dispatch index
    (-1 when no plan is active)."""
    state = _active
    if state is None:
        return -1
    plan = state.plan
    with state.lock:
        i = state.dispatches
        state.dispatches += 1
        straggle = i in plan.straggler_at and plan.straggler_delay_s > 0
        die = i in plan.die_at
        crash = i in plan.crash_at
        if straggle:
            state.injected["straggler"] += 1
    if straggle:
        time.sleep(plan.straggler_delay_s)
    if die:
        with state.lock:
            state.injected["death"] += 1
        raise ExecutorDeath(f"injected executor death at dispatch {i}")
    if crash:
        with state.lock:
            state.injected["crash"] += 1
        raise InjectedFault(f"injected dispatch crash at dispatch {i}")
    if plan.poison_key is not None and xs is not None:
        if bool(np.any(np.asarray(xs) == plan.poison_key)):
            with state.lock:
                state.injected["poison"] += 1
            raise InjectedFault(
                f"poison key {plan.poison_key!r} in batch (dispatch {i})")
    return i


def stats() -> dict:
    """Counters of the active plan (what fired so far); an empty dict when
    no plan is active."""
    state = _active
    if state is None:
        return {}
    with state.lock:
        return {"dispatches": state.dispatches,
                "corrupt_launches": state.corrupt_launches,
                **state.injected}
