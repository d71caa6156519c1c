"""Declarative communication contracts, checked against program runs
(counterpart of repro.analysis.contracts).

A `CommsContract` states what a front-door program may do on the wire:
exact or bounded collective counts, forbidden primitives, the calls of
every splitter round, the purity of the rounds after the early exit, and
pinned all_gather operand widths. Contracts are registered next to the
code they constrain (repro_torch.sort.partitioners, .semisort) and proved
by `check_program`, which runs the program once and reads the `Comm`
records of the run (repro_torch.parallel.comm.recording).

The two packages count differently. The reference counts a jaxpr
statically: every collective equation once, the round scan's body once.
The port counts calls as they run, each tagged with the splitter round it
ran in (`comm.round(j)`). So each field reads:

  total_counts          exact calls, by primitive, OUTSIDE every round;
  max_total             upper bounds on those same calls;
  forbid                primitives that no call may use, in a round or
                        out of one;
  round_collectives     exact calls, by primitive, in EVERY round that
                        ran (a round entered and not skipped by the early
                        exit); a contract with any round field needs at
                        least one round entered ("round_scan");
  max_round_collectives a cap on the calls of every round that ran;
  converged_branch_pure once the host's early exit fires
                        (`comm.early_exit()`), no later call of that
                        loop of rounds runs inside a round: the converged
                        branch communicates nothing;
  gather_widths         the last-axis widths of the recorded all_gather
                        operands, in call order (a round's gather once
                        for each round that ran);
  batch_invariant       `check_batch_invariance` runs the program at
                        B = 1 and B = 8 and compares the named
                        primitives' counts with each round body counted
                        once (the reference's static count), so a
                        per-request call or a per-request round body
                        shows, and the data-dependent number of rounds
                        that ran does not.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.analysis import comms

__all__ = [
    "COLLECTIVE_PRIMITIVES",
    "CommsContract",
    "ContractViolation",
    "ContractReport",
    "check_program",
    "check_events",
    "check_batch_invariance",
    "register_contract",
    "get_contract",
    "registered_contracts",
]

COLLECTIVE_PRIMITIVES = ("all_gather", "all_to_all", "psum", "ppermute",
                         "ragged_all_to_all")


@dataclasses.dataclass(frozen=True)
class CommsContract:
    """What a program may do on the wire. ``None`` fields are unchecked."""

    name: str
    description: str = ""
    #: exact calls by primitive outside every splitter round (0 bans one)
    total_counts: Optional[Mapping[str, int]] = None
    #: upper bounds on the calls outside every splitter round
    max_total: Optional[Mapping[str, int]] = None
    #: primitives that must not be called anywhere
    forbid: Tuple[str, ...] = ()
    #: exact calls by primitive in every splitter round that ran
    round_collectives: Optional[Mapping[str, int]] = None
    #: cap on the calls of every splitter round that ran
    max_round_collectives: Optional[int] = None
    #: no round call after the host's early exit fired
    converged_branch_pure: bool = False
    #: exact all_gather operand last-axis widths, in call order
    gather_widths: Optional[Tuple[int, ...]] = None
    #: primitives whose static count must not change with batch size
    #: (checked by check_batch_invariance, not check_program)
    batch_invariant: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ContractViolation:
    rule: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class ContractReport:
    contract: str
    ok: bool
    violations: Tuple[ContractViolation, ...]
    comms: Optional[comms.CommsReport] = None

    def raise_if_failed(self) -> "ContractReport":
        if not self.ok:
            detail = "\n  ".join(str(v) for v in self.violations)
            raise AssertionError(
                f"CommsContract '{self.contract}' violated:\n  {detail}")
        return self

    def to_json(self) -> dict:
        return {
            "contract": self.contract,
            "ok": self.ok,
            "violations": [dataclasses.asdict(v) for v in self.violations],
        }


def _rounds(events):
    """-> (rounds that ran: {(comm, j): Counter of calls}, calls recorded
    after an early exit fired in their loop, any round entered)."""
    ran: Dict[tuple, Counter] = {}
    exited: set = set()
    after_exit: list = []
    converged: set = set()     # comms whose current loop has exited
    last_j: dict = {}
    entered = False
    for e in events:
        if e.kind == "round":
            entered = True
            if e.j is not None and e.j < last_j.get(e.comm, -1):
                converged.discard(e.comm)      # a new loop of rounds
            last_j[e.comm] = e.j
            ran.setdefault((e.comm, e.j), Counter())
        elif e.kind == "exit":
            exited.add((e.comm, e.j))
            converged.add(e.comm)
        elif e.record.round is not None:
            ran.setdefault((e.comm, e.j), Counter())[e.record.collective] += 1
            if e.comm in converged:
                after_exit.append(e.record)
        else:
            converged.discard(e.comm)          # the loop of rounds ended
    return ({k: v for k, v in ran.items() if k not in exited}, after_exit,
            entered)


def check_events(events, contract: CommsContract,
                 label: Optional[str] = None) -> ContractReport:
    """Prove `contract` over the CommEvents of one program run."""
    violations = []
    calls = [e.record for e in events if e.kind == "call"]
    outside = Counter(r.collective for r in calls if r.round is None)
    anywhere = Counter(r.collective for r in calls)
    report = comms.analyze_events(events, label=label or contract.name)

    for prim, want in (contract.total_counts or {}).items():
        got = outside.get(prim, 0)
        if got != want:
            violations.append(ContractViolation(
                "total_counts", f"{prim}: expected {want}, found {got}"))

    for prim, cap in (contract.max_total or {}).items():
        got = outside.get(prim, 0)
        if got > cap:
            violations.append(ContractViolation(
                "max_total", f"{prim}: at most {cap} allowed, found {got}"))

    for prim in contract.forbid:
        got = anywhere.get(prim, 0)
        if got:
            violations.append(ContractViolation(
                "forbid", f"{prim} is forbidden, found {got}"))

    needs_round = (contract.round_collectives is not None
                   or contract.max_round_collectives is not None
                   or contract.converged_branch_pure)
    ran, after_exit, entered = _rounds(events)
    if needs_round and not entered:
        violations.append(ContractViolation(
            "round_scan", "no splitter round was entered (no comm.round)"))

    if needs_round and entered:
        for prim, want in (contract.round_collectives or {}).items():
            bad = sorted((j, c.get(prim, 0)) for (_, j), c in ran.items()
                         if c.get(prim, 0) != want)
            if bad:
                got = sorted({n for _, n in bad})
                bad = [j for j, _ in bad]
                violations.append(ContractViolation(
                    "round_collectives",
                    f"{prim} per round: expected {want}, found {got} in "
                    f"rounds {bad}"))
        cap = contract.max_round_collectives
        if cap is not None:
            over = sorted((j, sum(c.values())) for (_, j), c in ran.items()
                          if sum(c.values()) > cap)
            if over:
                violations.append(ContractViolation(
                    "max_round_collectives",
                    f"rounds issue {[n for _, n in over]} collectives "
                    f"(rounds {[j for j, _ in over]}), cap is {cap}"))
        if contract.converged_branch_pure and after_exit:
            violations.append(ContractViolation(
                "converged_branch_pure",
                f"{len(after_exit)} collective call(s) "
                f"({sorted({r.collective for r in after_exit})}) after the "
                "early exit fired; the converged rounds must be "
                "communication-free"))

    if contract.gather_widths is not None:
        got_widths = [r.shape[-1] if r.shape else 1 for r in calls
                      if r.collective == "all_gather"]
        if got_widths != list(contract.gather_widths):
            violations.append(ContractViolation(
                "gather_widths",
                f"all_gather operand widths {got_widths}, expected "
                f"{list(contract.gather_widths)}"))

    return ContractReport(contract=contract.name, ok=not violations,
                          violations=tuple(violations), comms=report)


def check_program(fn: Callable, args: Sequence[Any],
                  contract: CommsContract) -> ContractReport:
    """Run ``fn(*args)`` once and prove the contract over its records."""
    _, events = comms.trace(fn, *args)
    return check_events(events, contract,
                        label=getattr(fn, "__name__", contract.name))


def check_batch_invariance(
        make_program: Callable[[int], Tuple[Callable, Sequence[Any]]],
        contract: CommsContract,
        batches: Tuple[int, int] = (1, 8)) -> ContractReport:
    """Prove the contract's ``batch_invariant`` primitives keep their
    static counts (a round body once) from B = batches[0] to batches[1]:
    ``make_program(batch) -> (fn, args)`` runs at both sizes."""
    prims = contract.batch_invariant or COLLECTIVE_PRIMITIVES
    counted = {}
    for b in batches:
        fn, args = make_program(b)
        _, events = comms.trace(fn, *args)
        counted[b] = comms.analyze_events(events).counts()
    lo, hi = batches
    violations = [
        ContractViolation(
            "batch_invariant",
            f"{prim}: {counted[lo].get(prim, 0)} at B={lo} but "
            f"{counted[hi].get(prim, 0)} at B={hi} — per-round "
            "collectives must be fused across the batch")
        for prim in prims
        if counted[lo].get(prim, 0) != counted[hi].get(prim, 0)]
    return ContractReport(contract=f"{contract.name}[batch]",
                          ok=not violations, violations=tuple(violations))


# ------------------------------------------------------------------ registry

_REGISTRY: Dict[str, CommsContract] = {}


def register_contract(key: str, contract: CommsContract) -> CommsContract:
    """Register a contract under ``key`` (idempotent for equal contracts)."""
    existing = _REGISTRY.get(key)
    if existing is not None and existing != contract:
        raise ValueError(f"conflicting contract already registered: {key}")
    _REGISTRY[key] = contract
    return contract


def get_contract(key: str) -> CommsContract:
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"no contract registered under {key!r}; known: "
            f"{sorted(_REGISTRY)}") from None


def registered_contracts() -> Dict[str, CommsContract]:
    return dict(_REGISTRY)
