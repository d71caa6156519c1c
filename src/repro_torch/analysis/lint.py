"""The analysis lint: `python -m repro_torch.analysis.lint` (counterpart of
repro.analysis.lint).

Sweeps the shipped program matrix: four partitioners x four exchanges,
multistage on its (2, 4) grid under each exchange, the splitter phases,
B in {1, 8}, the three kernel policies (which must make the same calls)
and the top-k program. It proves every registered CommsContract over the
`Comm` records of each run, checks the Hopper budgets of the kernels,
and runs the purity audits: each front door's host syncs against its
pinned formula (on the card under `set_sync_debug_mode("error")`), the
warm-cache retrace audit and semisort's deferred heavy statistics.
Writes the reference's ANALYSIS.json schema plus "device" (and "card" on
the card) and exits nonzero on any violation.

Flags:
  --device cuda|cpu  where the programs run (default cuda; no card raises)
  --out PATH         where to write the report (default ANALYSIS_torch.json)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

ALGOS = ("hss", "sample_random", "sample_regular", "ams")
P, N_LOCAL = 8, 128
BATCHES = (1, 8)
STAGES = (2, 4)
POLICIES = ("auto", "kernel", "torch")
PURITY_N = P * 131     # a shape bucket the test suite does not use


def _merge_counts(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def _record(results, section, name, ok, detail=""):
    results["checks"].append(
        {"section": section, "name": name, "ok": bool(ok), "detail": detail})
    status = "ok" if ok else "FAIL"
    print(f"  [{status:4s}] {section:9s} {name}" + (f"  {detail}" if not ok
                                                    else ""))
    if not ok:
        results["ok"] = False


def _check(results, section, name, report):
    detail = "; ".join(str(v) for v in report.violations)
    _record(results, section, name, report.ok, detail)


def run_contracts(results, device) -> None:
    from repro_torch.analysis import comms, contracts
    from repro_torch.analysis.contracts import CommsContract
    from repro_torch.analysis.programs import (
        available_exchanges, make_topk_program, partitioner_program,
        splitters_program)
    from repro_torch.core.exchange import BATCH_FUSED_STRATEGIES
    from repro_torch.sort.partitioners import (
        MULTISTAGE_BASE_COLLECTIVES, MULTISTAGE_ROUND_COLLECTIVES,
        multistage_exchange_calls)
    from repro_torch.sort.spec import SortSpec

    exchanges = available_exchanges()
    kw = dict(p=P, n_local=N_LOCAL, device=device)

    print("contracts: splitter phase")
    for algo in ALGOS:
        contract = contracts.get_contract(f"splitters:{algo}")
        fn, args = splitters_program(algo, **kw)
        _check(results, "contracts", f"splitters:{algo}",
               contracts.check_program(fn, args, contract))
        _check(results, "contracts", f"splitters:{algo}[batch]",
               contracts.check_batch_invariance(
                   lambda b, a=algo: splitters_program(a, batch=b, **kw),
                   contract, batches=BATCHES))

    def full_contract(name, base, exchange, times=1):
        ex = contracts.get_contract(f"exchange:{exchange}")
        return CommsContract(
            name=name, description=ex.description,
            total_counts=_merge_counts(
                base.total_counts,
                {k: times * v for k, v in ex.total_counts.items()}),
            forbid=("ppermute",),
            round_collectives=base.round_collectives,
            converged_branch_pure=base.converged_branch_pure)

    print("contracts: full pipeline (splitters + exchange)")
    reports = []
    for algo in ALGOS:
        base = contracts.get_contract(f"splitters:{algo}")
        for exchange in exchanges:
            full = full_contract(f"{algo}+{exchange}", base, exchange)
            fn, args = partitioner_program(algo, exchange=exchange, **kw)
            _, events = comms.trace(fn, *args)
            _check(results, "contracts", full.name,
                   contracts.check_events(events, full))
            reports.append(comms.analyze_events(events,
                                                label=full.name).to_json())
            if exchange in BATCH_FUSED_STRATEGIES:
                _check(results, "contracts", f"{full.name}[batch]",
                       contracts.check_batch_invariance(
                           lambda b, a=algo, e=exchange: partitioner_program(
                               a, exchange=e, batch=b, **kw),
                           full, batches=BATCHES))

    print(f"contracts: multistage on {STAGES} (base + 2 stages' exchanges)")
    r1, r2 = STAGES
    ms_base = CommsContract(name="multistage",
                            total_counts=MULTISTAGE_BASE_COLLECTIVES,
                            round_collectives=MULTISTAGE_ROUND_COLLECTIVES)
    for exchange in exchanges:
        full = full_contract(f"multistage+{exchange}", ms_base, exchange,
                             multistage_exchange_calls(exchange, r1, r2))
        spec = SortSpec(algorithm="multistage", exchange=exchange, shards=P,
                        stages=STAGES, device=str(device))
        fn, args = partitioner_program("multistage", spec=spec, **kw)
        _, events = comms.trace(fn, *args)
        _check(results, "contracts", full.name,
               contracts.check_events(events, full))
        reports.append(comms.analyze_events(events,
                                            label=full.name).to_json())

    print("contracts: kernel-policy independence (hss+dense)")
    base = contracts.get_contract("splitters:hss")
    full = full_contract("hss+dense", base, "dense")
    seen = {}
    for policy in POLICIES:
        spec = SortSpec(algorithm="hss", exchange="dense", shards=P,
                        kernel_policy=policy, device=str(device))
        fn, args = partitioner_program("hss", spec=spec, **kw)
        _, events = comms.trace(fn, *args)
        _check(results, "contracts", f"hss+dense[kernel={policy}]",
               contracts.check_events(events, full))
        seen[policy] = [e.record for e in events if e.kind == "call"]
    same = all(v == seen["auto"] for v in seen.values())
    _record(results, "contracts", "hss+dense[policies: same records]", same,
            "" if same else "the kernel policies made different calls")

    print("contracts: top_k")
    topk = contracts.get_contract("top_k")
    for batch in (None, 4):
        prog, args, c = make_topk_program(k=10, batch=batch, **kw)
        pinned = dataclasses.replace(topk, gather_widths=(c,))
        tag = "single" if batch is None else f"B={batch}"
        _check(results, "contracts", f"top_k[{tag}]",
               contracts.check_program(prog, args, pinned))
    _check(results, "contracts", "top_k[batch]",
           contracts.check_batch_invariance(
               lambda b: make_topk_program(k=10, batch=b, **kw)[:2],
               topk, batches=BATCHES))

    results["comms_reports"] = reports


def run_budgets(results) -> None:
    from repro_torch.analysis import budgets

    print("budgets: Hopper shared memory and registers")
    try:
        checked = budgets.check_kernel_budgets()
    except budgets.BudgetError as e:
        _record(results, "budgets", "kernel_budgets", False, str(e))
        return
    for fp in checked:
        _record(results, "budgets", f"{fp.kernel}:{fp.entry}[{fp.config}]",
                True)
    results["budget_footprints"] = [fp.to_json() for fp in checked]


def purity_doors(device, n: int = PURITY_N, batch: int = 8):
    """The front doors the sync audit runs: door -> (call, batch). Keys
    and draws come from seeds on the host, so every device runs the same
    rounds."""
    import numpy as np
    import torch

    from repro_torch.analysis.programs import host_draws
    from repro_torch.sort import (
        SortSpec, argsort, semisort, sort, sort_batched, sort_kv, top_k)

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(device)
    xs = torch.from_numpy(np.stack([rng.permutation(n).astype(np.int32)
                                    for _ in range(batch)])).to(device)
    small = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32)).to(
        device)
    vals = np.arange(n, dtype=np.int32)
    spec = SortSpec(device=str(device))
    u = host_draws(spec.shards)
    return {
        "sort": (lambda: sort(x, spec, uniform=u).gather(), 1),
        "sort_batched": (
            lambda: sort_batched(xs, spec, uniform=u).gather_all(), batch),
        "argsort": (lambda: argsort(x, spec, uniform=u), 1),
        "sort_kv": (lambda: sort_kv(x, vals, spec, uniform=u), 1),
        "semisort": (lambda: semisort(small, spec=spec, uniform=u).gather(),
                     1),
        "top_k": (lambda: top_k(x, 100, spec), 1),
        "sort[retry]": (lambda: sort(x, spec, uniform=u,
                                     on_overflow="retry").gather(), 1),
        "sort[verify=full]": (lambda: sort(x, spec, uniform=u,
                                           verify="full").gather(), 1),
    }


def run_purity(results, device) -> None:
    import numpy as np
    import torch

    from repro_torch.analysis import purity
    from repro_torch.sort import (
        SortSpec, semisort, sort, sort_batched, top_k)

    print("purity: host syncs against the pinned formulas")
    counts = {}
    for door, (call, batch) in purity_doors(device).items():
        call()      # builds the kernels and warms the allocator first
        try:
            audit = purity.count_host_syncs(call, device=device)
            counts[door] = dict(purity.check_pinned(door, audit, batch))
            ok, detail = True, ""
        except purity.HostSyncViolation as e:
            ok, detail = False, str(e)
        _record(results, "purity", f"syncs:{door}", ok, detail)
    results["sync_counts"] = counts

    print("purity: warm front doors never retrace")
    rng = np.random.default_rng(0)
    n = PURITY_N
    spec = SortSpec(exchange="allgather", tag=False, device=str(device))
    keys = lambda: torch.from_numpy(  # noqa: E731
        rng.permutation(n).astype(np.int32)).to(device)
    audits = {
        "sort": lambda: sort(keys(), spec),
        "sort_batched": lambda: sort_batched(
            torch.stack([keys(), keys()]), spec),
        "semisort": lambda: semisort(torch.from_numpy(
            rng.integers(0, 50, size=n).astype(np.int32)).to(device),
            spec=spec),
        "top_k": lambda: top_k(keys(), 10, spec),
    }
    for name, call in audits.items():
        try:
            purity.audit_retrace(call)
            ok, detail = True, ""
        except purity.RetraceViolation as e:
            ok, detail = False, str(e)
        _record(results, "purity", f"retrace:{name}", ok, detail)

    print("purity: semisort heavy stats materialize lazily")
    out = semisort(torch.from_numpy(
        rng.integers(0, 50, size=n).astype(np.int32)).to(device), spec=spec)
    deferred = purity.semisort_deferred(out)
    _record(results, "purity", "semisort:deferred_heavy_stats", deferred,
            "" if deferred else "front door materialized heavy stats "
            "eagerly (host-blocking sync on the serving hot path)")


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(device: str = "cuda") -> dict:
    """The whole sweep on `device`; returns the report."""
    import torch

    from repro_torch.sort.api import resolve_device

    dev = resolve_device(device)
    results = {
        "schema": 1,
        "torch": torch.__version__,
        "platform": dev.type,
        "device": str(dev),
        "matrix": {"p": P, "n_local": N_LOCAL, "batches": list(BATCHES),
                   "stages": list(STAGES), "policies": list(POLICIES)},
        "ok": True,
        "checks": [],
    }
    if dev.type == "cuda":
        results["card"] = card_name()
    run_contracts(results, dev)
    run_budgets(results)
    run_purity(results, dev)
    results["failures"] = sum(1 for c in results["checks"] if not c["ok"])
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.lint",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="ANALYSIS_torch.json")
    args = ap.parse_args(argv)
    results = run(args.device)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(results['checks'])} checks, {results['failures']} "
          f"failure(s) -> {args.out}")
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
