"""The port's analysis layer (repro_torch.analysis) on the CPU.

Every contract rule must fire: each test runs a deliberately violating
toy program over a `Comm` (an extra all_to_all, a call after the early
exit, a wrong round count, a wrong gather width, a B-dependent psum, an
oversized kernel block, an unexplained sync, a caller that bypasses the
cache) and asserts the checker reports exactly that rule, beside the
compliant twin that passes. Then the port's cost model is held to the
reference's (repro.analysis.comms over repro.analysis.programs) on every
partitioner under the three exchanges the reference traces on the CPU,
the registered contracts to the reference's totals, the front doors'
host syncs to their pinned formulas, and the lint's CPU run to the
committed ANALYSIS_torch.json.
"""
import dataclasses
import importlib
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis.comms as rcomms
import repro.analysis.contracts as rcontracts
import repro.analysis.programs as rprograms
import repro_torch.sort  # noqa: F401  (registers the contracts)
from repro.sort import SortSpec as RefSortSpec
from repro_torch.analysis import budgets, comms, contracts, lint, purity
from repro_torch.analysis import programs
from repro_torch.analysis.contracts import CommsContract
from repro_torch.core import exchange as texchange
from repro_torch.parallel.comm import Comm
from repro_torch.runtime import syncs
from repro_torch.sort import SortSpec, sort
from repro_torch.sort.semisort import semisort
from torch_parity import reference_draws

rexchange = importlib.import_module("repro.core.exchange")

pytestmark = pytest.mark.analysis

P, N_LOCAL = 8, 128
ROOT = Path(__file__).resolve().parents[1]


def _x(batch=None):
    shape = (P, N_LOCAL) if batch is None else (batch, P, N_LOCAL)
    return torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape)


def _rules(report):
    return sorted({v.rule for v in report.violations})


def _check(fn, contract):
    return contracts.check_program(fn, (_x(),), contract)


# --------------------------------------------------------------- contracts --

@pytest.mark.parametrize("contraband", [True, False])
def test_total_counts_fires_on_extra_all_to_all(contraband):
    def program(x):
        comm = Comm(P)
        g = comm.all_gather(x).sum()
        if contraband:
            comm.all_to_all(x.reshape(P, P, -1))
        return x + g

    contract = CommsContract(name="toy", total_counts={
        "all_gather": 1, "all_to_all": 0})
    report = _check(program, contract)
    if contraband:
        assert _rules(report) == ["total_counts"]
        assert any("all_to_all" in v.message for v in report.violations)
    else:
        report.raise_if_failed()


@pytest.mark.parametrize("hop", [True, False])
def test_forbid_and_max_total_fire(hop):
    def program(x):
        comm = Comm(P)
        z = comm.psum(x)
        if hop:
            y = comm.ppermute(x, [(i, (i + 1) % P) for i in range(P)])
            z = z + comm.psum(y)
        return z

    contract = CommsContract(name="toy", forbid=("ppermute",),
                             max_total={"psum": 1})
    report = _check(program, contract)
    assert _rules(report) == (["forbid", "max_total"] if hop else [])


def _rounds_program(converged_pure):
    """A 3-round splitter-style loop: round 0 gathers and reduces, then
    the host's early exit fires; the violating twin still reduces in the
    rounds after it (the reference's cond with both branches
    communicating)."""
    def program(x):
        comm = Comm(P)
        for j in range(3):
            with comm.round(j):
                if j >= 1:
                    comm.early_exit()
                    if not converged_pure:
                        x = x - comm.psum(x)
                    continue
                x = x + comm.all_gather(x).sum() + comm.psum(x)
        return x
    return program


def test_converged_branch_pure_fires_when_the_exit_still_communicates():
    contract = CommsContract(name="toy", converged_branch_pure=True,
                             round_collectives={"all_gather": 1})
    bad = _check(_rounds_program(False), contract)
    assert _rules(bad) == ["converged_branch_pure"]
    _check(_rounds_program(True), contract).raise_if_failed()


def test_round_collectives_and_cap_fire():
    contract = CommsContract(name="toy",
                             round_collectives={"all_gather": 2},
                             max_round_collectives=1)
    report = _check(_rounds_program(True), contract)
    # 1 gather (want 2) and gather + psum = 2 collectives (cap 1)
    assert _rules(report) == ["max_round_collectives", "round_collectives"]
    ok = CommsContract(name="toy", round_collectives={"all_gather": 1,
                                                      "psum": 1},
                       max_round_collectives=2)
    _check(_rounds_program(True), ok).raise_if_failed()


def test_round_scan_required_but_missing_fires():
    report = _check(lambda x: x + Comm(P).psum(x),
                    CommsContract(name="toy",
                                  round_collectives={"all_gather": 1}))
    assert _rules(report) == ["round_scan"]


def test_gather_widths_fire_on_unpruned_operand():
    contract = CommsContract(name="toy", gather_widths=(16,))
    unpruned = _check(lambda x: Comm(P).all_gather(x), contract)
    assert _rules(unpruned) == ["gather_widths"]
    _check(lambda x: Comm(P).all_gather(x[..., :16]),
           contract).raise_if_failed()


@pytest.mark.parametrize("fused", [False, True])
def test_batch_invariance_fires_on_b_dependent_psum(fused):
    def make_program(b):
        def program(xs):
            comm = Comm(P)
            rows = xs.transpose(0, 1)                 # (p, B, n)
            if fused:
                return comm.psum(rows)                # one batched psum
            return torch.stack([comm.psum(rows[:, i])  # one per request
                                for i in range(b)])
        return program, (_x(b),)

    contract = CommsContract(name="toy", batch_invariant=("psum",))
    report = contracts.check_batch_invariance(make_program, contract,
                                              batches=(1, 8))
    if fused:
        report.raise_if_failed()
    else:
        assert _rules(report) == ["batch_invariant"]
        assert "B=8" in report.violations[0].message


def test_registry_rejects_conflicting_contract():
    shipped = contracts.get_contract("splitters:hss")
    assert shipped.total_counts == {"all_gather": 0, "psum": 0,
                                    "all_to_all": 0}
    with pytest.raises(ValueError, match="conflicting contract"):
        contracts.register_contract(
            "splitters:hss", CommsContract(name="splitters:hss"))
    # re-registering the identical contract is idempotent
    contracts.register_contract("splitters:hss", shipped)


@pytest.mark.parametrize("algo", ["hss", "sample_random", "sample_regular",
                                  "ams"])
def test_splitter_contracts_translate_the_reference(algo):
    """The port's calls outside the rounds plus one round's calls are the
    reference's static totals, the round body counted once."""
    key = f"splitters:{algo}"
    ref, port = rcontracts.get_contract(key), contracts.get_contract(key)
    total = Counter(port.total_counts)
    total.update(port.round_collectives or {})
    assert dict(total) == {k: v for k, v in ref.total_counts.items()}
    assert (port.round_collectives is not None) == (algo in ("hss", "ams"))
    assert port.converged_branch_pure == ref.converged_branch_pure


def test_exchange_tables_differ_from_the_reference_only_as_documented():
    """ROADMAP queue 3 item 16: ragged's truncation psum, and ragged
    batch-fused."""
    for strategy, row in rexchange.EXCHANGE_COLLECTIVES.items():
        want = dict(row)
        if strategy == "ragged":
            want["psum"] += 1
        assert texchange.EXCHANGE_COLLECTIVES[strategy] == want
        assert (contracts.get_contract(f"exchange:{strategy}").total_counts
                == want)
    assert texchange.BATCH_FUSED_STRATEGIES == (
        rexchange.BATCH_FUSED_STRATEGIES + ("ragged",))
    assert "queue 3 item 16" in contracts.get_contract(
        "exchange:ragged").description


# ------------------------------------------------------------------- comms --

def test_cost_model_counts_rounds_that_ran_and_per_shard_bytes():
    report = comms.analyze(_rounds_program(True), _x(), label="toy")
    gathers = [c for c in report.collectives if c.primitive == "all_gather"]
    assert len(gathers) == 1
    (g,) = gathers
    assert g.trips == 1                    # the exit skipped rounds 1, 2
    assert g.shape == (N_LOCAL,) and g.operand_bytes == 4 * N_LOCAL
    assert g.axes == ("sort",) and g.path == ("rounds",)
    assert g.total_bytes == g.trips * g.operand_bytes
    assert report.counts() == {"all_gather": 1, "psum": 1}
    assert report.in_round_scan() == report.collectives
    assert "toy" in report.render()


def test_cost_model_folds_every_round_of_a_loop():
    def program(x):
        comm = Comm(P)
        rows = x[:, None]                                  # (p, B=1, n)
        for j in range(4):
            with comm.round(j):
                comm.all_gather(rows[..., :32])
                comm.psum(rows[..., :10])
        comm.psum(rows[..., 0])
        return x

    report = comms.analyze(program, _x())
    got = [(c.primitive, c.shape, c.operand_bytes, c.trips, c.path)
           for c in report.collectives]
    assert got == [("all_gather", (1, 32), 128, 4, ("rounds",)),
                   ("psum", (1, 10), 40, 4, ("rounds",)),
                   ("psum", (1,), 4, 1, ())]
    assert report.total_rounds() == 9
    assert report.total_bytes() == 4 * 128 + 4 * 40 + 4


EXCHANGES = ("dense", "dense_spill", "allgather")


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("algo", ["hss", "sample_random", "sample_regular",
                                  "ams"])
def test_cost_model_matches_the_reference(algo, exchange):
    """The port's records against the reference's jaxpr model at p = 8,
    n_local = 128, B = 1: the same primitives in the same order, the same
    per-shard element counts, dtypes and operand bytes; trips 1 outside
    the rounds, and a round call's trips (the rounds that ran) at most
    the reference's scan length."""
    fn, args = rprograms.partitioner_program(algo, exchange=exchange, p=P,
                                             n_local=N_LOCAL)
    want = rcomms.analyze(fn, *args).to_json()["collectives"]
    draws = reference_draws(RefSortSpec(algorithm=algo), P, P * N_LOCAL)
    fn, args = programs.partitioner_program(algo, exchange=exchange, p=P,
                                            n_local=N_LOCAL, uniform=draws,
                                            device="cpu")
    got = comms.analyze(fn, *args).to_json()["collectives"]
    assert [c["primitive"] for c in got] == [c["primitive"] for c in want]
    for g, w in zip(got, want):
        assert int(np.prod(g["shape"])) == int(np.prod(w["shape"])), (g, w)
        assert g["dtype"] == w["dtype"], (g, w)
        assert g["operand_bytes"] == w["operand_bytes"], (g, w)
        if g["path"] == ():
            assert g["trips"] == w["trips"] == 1, (g, w)
        else:
            assert 1 <= g["trips"] <= w["trips"], (g, w)


# -------------------------------------------------------------------- budgets --

def test_budget_fires_on_oversized_block():
    with pytest.raises(budgets.BudgetError) as e:
        dataclasses.replace(budgets.sort_block_footprint(1024),
                            static_smem=4 * 32 * 1024 * 4).check()
    # the failure message shows the arithmetic and the budget
    assert "static shared memory" in str(e.value)
    assert str(budgets.HOPPER["smem_static_max"]) in str(e.value)
    budgets.sort_block_footprint(1024).check()      # the twin fits


def test_budget_fires_on_oversized_probe_tile():
    with pytest.raises(budgets.BudgetError, match="kProbeTile=65536"):
        budgets.probe_count_footprint(tile=1 << 16).check()
    budgets.probe_count_footprint().check()


def test_budget_fires_on_dynamic_smem_without_opt_in():
    fp = budgets.merge_footprint(16384)
    assert fp.dynamic_smem == 65536 and fp.opt_in == 65536
    fp.check()
    with pytest.raises(budgets.BudgetError, match="opt-in of 49152"):
        dataclasses.replace(fp, opt_in=49152).check()
    with pytest.raises(budgets.BudgetError, match="232448"):
        dataclasses.replace(fp, dynamic_smem=240_000,
                            opt_in=240_000).check()
    with pytest.raises(budgets.BudgetError, match="2048 threads"):
        budgets.merge_footprint(1 << 16).check()


def test_shipped_kernel_configs_fit_the_budget():
    checked = budgets.check_kernel_budgets()
    # K4s, K5 and K6's two launches at each key type, int32 and int64
    assert len(checked) == 10 + 14 + 2 + 1 + 2 + 2 + 4
    assert {fp.kernel for fp in checked} == {"K1", "K2", "K3", "K4", "K4s",
                                             "K5", "K6"}
    for k6 in budgets.sample_compact_footprints(config="int64"):
        assert (k6.static_smem, k6.threads, k6.max_registers) == (3104, 256,
                                                                  64)
    k1 = budgets.sort_block_footprint(1024)
    assert (k1.static_smem, k1.threads, k1.max_registers) == (16384, 128, 64)
    assert budgets.probe_count_footprint().static_smem == 16384
    k5 = budgets.merge_path_footprint()
    assert (k5.static_smem, k5.threads, k5.max_registers) == (15376, 256, 64)
    k5 = budgets.merge_path_footprint(config="int64")
    assert (k5.static_smem, k5.threads, k5.max_registers) == (30752, 256, 64)
    smem = [fp for fp in checked if fp.entry == "bitonic_merge_smem_kernel"]
    assert [fp.dynamic_smem for fp in smem] == [8192, 16384, 32768, 65536]


PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124bitonic_sort_warp_kernelILi1024EEvPKiPil' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124bitonic_sort_warp_kernelILi1024EEvPKiPil
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 16384 bytes smem, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125bitonic_merge_smem_kernelILi16384EEvPKiPii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125bitonic_merge_smem_kernelILi16384EEvPKiPii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, 372 bytes cmem[0]
"""


def test_ptxas_report_holds_the_model():
    rows = budgets.check_ptxas([budgets.sort_block_footprint(1024),
                                budgets.merge_footprint(16384)], PTXAS)
    assert [(r["smem"], r["registers"]) for r in rows] == [(16384, 40),
                                                           (0, 56)]
    with pytest.raises(budgets.BudgetError, match="8192 B"):
        budgets.check_ptxas([budgets.sort_block_footprint(16)], PTXAS
                            .replace("1024EE", "16EE"))
    with pytest.raises(budgets.BudgetError, match="no probe_rank_count"):
        budgets.check_ptxas([budgets.probe_count_footprint()], PTXAS)


PTXAS_K5 = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123merge_path_pairs_kernelIiEEvPKT_PKiPS1_Piiilllli' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123merge_path_pairs_kernelIiEEvPKT_PKiPS1_Piiilllli
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 43 registers, used 1 barriers, 15376 bytes smem, 408 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123merge_path_pairs_kernelIlEEvPKT_PKiPS1_Piiilllli' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123merge_path_pairs_kernelIlEEvPKT_PKiPS1_Piiilllli
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 30752 bytes smem, 408 bytes cmem[0]
"""


def test_ptxas_report_tells_the_key_types_apart():
    """K5's int32 and int64 instantiations are two entries of the report,
    each held to its own footprint, with its spills."""
    report = budgets.ptxas_report(PTXAS_K5)
    assert report[("merge_path_pairs_kernel", "int32")] == {
        "registers": 43, "smem": 15376, "spill_bytes": 0}
    assert report[("merge_path_pairs_kernel", "int64")] == {
        "registers": 64, "smem": 30752, "spill_bytes": 16}
    rows = budgets.check_ptxas(
        [budgets.merge_path_footprint(config=c) for c in ("int32", "int64")],
        PTXAS_K5)
    assert [r["config"] for r in rows] == ["int32", "int64"]


# ------------------------------------------------------------------ purity --

@pytest.fixture(scope="module")
def doors():
    return lint.purity_doors("cpu")


@pytest.mark.parametrize("door", purity.DOORS)
def test_front_door_syncs_match_their_pinned_formula(doors, door):
    call, batch = doors[door]
    audit = purity.count_host_syncs(call, device="cpu")
    got = purity.check_pinned(door, audit, batch)
    if door != "top_k":
        assert got["hss.early_exit"] >= 1 and got["plan.probe"] == 1


def test_unexplained_sync_fires(doors):
    """A second gather is a sync no formula explains; the twin passes."""
    call, _ = doors["sort"]
    audit = purity.count_host_syncs(lambda: (call(), call()), device="cpu")
    with pytest.raises(purity.HostSyncViolation, match="pinned formula"):
        purity.check_pinned("sort", audit)
    purity.check_pinned("sort", purity.count_host_syncs(call, device="cpu"))
    with pytest.raises(ValueError, match="undocumented sync site"):
        with syncs.sync_site("item"):
            pass


def test_early_exit_reads_follow_the_rounds():
    audit = purity.count_host_syncs(
        lambda: sort(np.random.default_rng(3).permutation(8 * 4096)
                     .astype(np.int32), SortSpec(device="cpu")),
        device="cpu")
    ran = len({c.record.round for c in audit.events if c.kind == "call"
               and c.record.round is not None})
    k = sum(1 for e in audit.events if e.kind == "round")
    assert audit.syncs["hss.early_exit"] == min(ran + 1, k)
    assert purity.early_exit_reads(audit.events) == min(ran + 1, k)


def test_audit_retrace_flags_cache_bypass():
    with pytest.raises(purity.RetraceViolation, match="bypasses the cache"):
        purity.audit_retrace(lambda: torch.arange(8) + 1)


def test_audit_retrace_flags_unkeyed_caller():
    rng = np.random.default_rng(0)
    sizes = iter([8 * 141, 8 * 142, 8 * 143])
    spec = SortSpec(exchange="allgather", tag=False, device="cpu")

    def call():
        return sort(rng.permutation(next(sizes)).astype(np.int32), spec)

    with pytest.raises(purity.RetraceViolation, match="re-traced"):
        purity.audit_retrace(call)


def test_audit_retrace_passes_warm_front_door():
    rng = np.random.default_rng(0)
    spec = SortSpec(exchange="allgather", tag=False, device="cpu")

    def call():
        return sort(rng.permutation(8 * 139).astype(np.int32), spec)

    out = purity.audit_retrace(call)
    np.testing.assert_array_equal(np.sort(out.gather()), out.gather())


def test_semisort_heavy_stats_materialize_lazily():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, size=8 * 137).astype(np.int32)
    out = semisort(x, spec=SortSpec(device="cpu"))
    assert purity.semisort_deferred(out)       # nothing copied yet
    before = syncs.snapshot()["semisort.host"]
    keys, counts_ = out.heavy_keys, out.heavy_counts
    assert not purity.semisort_deferred(out)   # one-shot materialization
    assert keys is out.heavy_keys and counts_ is out.heavy_counts
    assert syncs.snapshot()["semisort.host"] - before == 2
    for k, c in zip(keys, counts_):
        assert c == np.sum(x == k), (k, c)


# -------------------------------------------------------------------- lint --

def test_lint_cpu_run_is_the_committed_report(tmp_path):
    """`python -m repro_torch.analysis.lint --device cpu` passes and makes
    the committed ANALYSIS_torch.json: every check, every collective."""
    out = tmp_path / "ANALYSIS_torch.json"
    assert lint.main(["--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "ANALYSIS_torch.json").read_text())
    assert got["failures"] == 0 and got["ok"]
    assert "ragged" not in got.get("skipped_exchanges", [])
    assert got["checks"] == want["checks"]
    assert got["comms_reports"] == want["comms_reports"]
    assert got["sync_counts"] == want["sync_counts"]
    assert got["budget_footprints"] == want["budget_footprints"]
    labels = {r["label"] for r in got["comms_reports"]}
    assert {"hss+ragged", "ams+ragged", "multistage+ragged"} <= labels


ENTRY_POINTS = {
    "program_keys": lambda: programs.program_keys(P, 16),
    "partitioner_program": lambda: programs.partitioner_program("hss"),
    "splitters_program": lambda: programs.splitters_program("hss"),
    "make_topk_program": lambda: programs.make_topk_program(),
    "count_host_syncs": lambda: purity.count_host_syncs(lambda: None),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_analysis_entry_points_default_to_the_card(entry):
    """With no `device`, the programs and the sync audit run on the card:
    without one they raise, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_only_pageable_uploads_are_queued():
    """A copy to the host, or one that stays there, blocks; an upload to
    the card from pageable memory is queued (a pinned source blocks, on
    the card's machine: tests/test_torch_cuda.py)."""
    x = torch.arange(4)
    assert syncs.queues_upload(x, "cuda")
    assert not syncs.queues_upload(x, "cpu")
    assert not syncs.queues_upload(x, None)
    assert syncs.move(x, None) is x
    assert syncs.move(x, "cpu") is x
    assert torch.equal(syncs.to_device([1, 2], torch.int32, "cpu"),
                       torch.tensor([1, 2], dtype=torch.int32))


def test_lint_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint.run("cuda")
