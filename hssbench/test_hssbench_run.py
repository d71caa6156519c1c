"""Runs of the harness on the CPU at a tiny size (the port's plain
versions, `device="cpu"`, `kernel_policy="torch"`): every cell matches
the plain reference; the control and each fault a cell can have, planted
under the timed path, make `correct` false; a cell added as new files
alone runs."""
import gc
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from hssbench import harness

CPU = {"device": "cpu", "kernel_policy": "torch"}
CELLS = ("sort.card_unif", "sort.host_unif")
TINY_KEYS = 8 * 2048
TINY_MIX = {"warmup": 1, "check": 3}
SECONDS = 0.25


@pytest.fixture(autouse=True)
def _unfreeze():
    """A run ends its set-up with `gc.freeze()`; the tests' worker goes on
    to other files, so give the collector its objects back."""
    yield
    gc.unfreeze()


def tiny_run(cell, seed=2 ** 31 + 17, trace=False, spec=None, **kw):
    return harness.run_cell(cell, seed, SECONDS, trace,
                            t_start=time.perf_counter(),
                            spec_overrides={**CPU, **(spec or {})},
                            mix_overrides=TINY_MIX, keys=TINY_KEYS, **kw)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cpu_run_matches_the_reference(cell, trace):
    line, notes = tiny_run(cell, trace=trace)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert line["checks"]["wrong_keys"] == {"value": 0, "limit": 0}
    assert line["checks"]["answers_checked"]["value"] == \
        min(3, line["attempted"])
    assert notes["done"] == line["attempted"]
    bench = harness.load_benchmark()
    if trace:
        names = {m["name"] for m in harness.per_layer_for(bench, cell)}
        # no device timeline and no kernel launch on the CPU
        assert set(line["metrics"]) <= names
    else:
        names = {m["name"] for m in harness.end_to_end_for(bench, cell)}
        assert set(line["metrics"]) == names
        assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    control = harness.load_config(
        harness.find_cell(harness.load_benchmark(), cell)["config"])
    line, _ = tiny_run(cell, spec=control["control"]["spec"])
    assert not line["correct"]


# -- faults planted under the timed path ----------------------------------

def _unchanged(orig):
    def sharded_batched(self, local, ctx):
        out, n_valid, *rest = orig(self, local, ctx)
        full = n_valid.new_full(n_valid.shape, local.shape[-1])
        return (local, full, *rest)   # the input handed back as it came
    return sharded_batched


def _half_left_out(orig):
    def sharded_batched(self, local, ctx):
        out, n_valid, *rest = orig(self, local, ctx)
        n_valid = n_valid.clone()
        n_valid[n_valid.shape[0] // 2:] = 0   # half of the rows dropped
        return (out, n_valid, *rest)
    return sharded_batched


def _no_exchange(orig):
    def exchange_batched(local_sorted, splitter_keys, **kw):
        p, batch, n = local_sorted.shape
        n_valid = torch.full((p, batch), n, dtype=torch.int32,
                             device=local_sorted.device)
        return local_sorted, n_valid, n_valid.new_zeros((batch,))
    return exchange_batched


def _answer_altered(orig):
    def decode_batched(self, raw):
        out = orig(self, raw)
        out.shards[..., 0, 0] += 1   # one key wrong where it is produced
        return out
    return decode_batched


FAULTS = {
    "unchanged": ("repro_torch.sort.partitioners", "Partitioner",
                  "sharded_batched", _unchanged),
    "half_left_out": ("repro_torch.sort.partitioners", "Partitioner",
                      "sharded_batched", _half_left_out),
    "no_exchange": ("repro_torch.sort.partitioners", None,
                    "exchange_batched", _no_exchange),
    "answer_altered": ("repro_torch.sort.adapters", "AdapterPlan",
                       "decode_batched", _answer_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib
    module, cls, attr, make = FAULTS[fault]
    target = importlib.import_module(module)
    if cls is not None:
        target = getattr(target, cls)
    monkeypatch.setattr(target, attr, make(getattr(target, attr)))
    line, _ = tiny_run(cell)
    assert not line["correct"], (fault, line["checks"])


# -- the command line -----------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: the run would measure it")
def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "hssbench/run.py", "--workload", "sort.card_unif",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


# -- a cell added as new files and entries only ---------------------------

def test_a_cell_added_as_new_files_is_picked_up(tmp_path):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    configs, mixes, metrics = (tmp_path / d for d in
                               ("configs", "traffic", "metrics"))
    shutil.copytree(harness.CONFIG_DIR, configs)
    shutil.copytree(harness.traffic.TRAFFIC_DIR, mixes)
    shutil.copytree(harness.METRICS_DIR, metrics)
    cfg = json.loads((configs / "hss_p8_2p28.json").read_text())
    cfg.update(name="hss_p8_verify", keys=TINY_KEYS,
               spec={**cfg["spec"], **CPU, "verify": "cheap"})
    (configs / "hss_p8_verify.json").write_text(json.dumps(cfg))
    (mixes / "device_skew2.json").write_text(json.dumps({
        "distribution": "SKEW2", "pool": 2, "input": "device",
        "result": "device", "warmup": 1, "check": 2}))
    (metrics / "front.calls.py").write_text(
        "def read(r):\n    return float(r.calls) if r.calls else None\n")
    bench["configs"].append({**bench["configs"][0], "name": "hss_p8_verify",
                             "file": "hssbench/configs/hss_p8_verify.json"})
    bench["workloads"].append({"name": "sort.card_skew2",
                               "config": "hss_p8_verify",
                               "traffic": "device_skew2", "chips": 1,
                               "why": "SKEW2 keys"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "sort.card_unif" in m["workloads"]:
            m["workloads"].append("sort.card_skew2")
    bench["per_layer"].append({
        "name": "front.calls.card", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "front door",
        "moves": "card_sort_keys_per_s", "workloads": ["sort.card_skew2"]})
    dirs = {"config_dir": configs, "traffic_dir": mixes,
            "metrics_dir": metrics}
    for trace in (False, True):
        line, _ = harness.run_cell(
            "sort.card_skew2", 5, SECONDS, trace,
            t_start=time.perf_counter(), bench=bench, **dirs)
        assert line["correct"], line["checks"]
        if trace:
            assert line["metrics"]["front.calls.card"]["value"] >= 1
        else:
            assert set(line["metrics"]) == {"card_sort_keys_per_s",
                                            "setup_s"}


def test_a_mix_with_a_key_the_generator_does_not_read_is_refused(tmp_path):
    mix = json.loads((harness.traffic.TRAFFIC_DIR / "device_unif.json")
                     .read_text())
    (tmp_path / "two_clients.json").write_text(json.dumps(
        {**mix, "clients": 2}))
    with pytest.raises(ValueError, match="clients"):
        harness.traffic.load_mix("two_clients", tmp_path)
    (tmp_path / "other_input.json").write_text(json.dumps(
        {**mix, "input": "pinned"}))
    with pytest.raises(ValueError, match="pinned"):
        harness.traffic.load_mix("other_input", tmp_path)
