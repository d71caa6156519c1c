"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

    python3 hssbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`) names a configuration and a traffic mix, both
data; `run_cell` finds them by name and drives `repro_torch.sort.sort`
with one caller, back to back, over the mix's inputs. With `--trace 0` the last line of standard output carries the
cell's end-to-end metrics; with `--trace 1` the window runs under
torch.profiler and the line carries its per-layer metrics, each read by
its own file under `hssbench/metrics/`. A JSON line of notes (calls, the
window's length, the card's name and power limit) comes before it.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

from hssbench import traffic
from hssbench.devtrace import Capture, Timeline
from hssbench.reference import Comparison, valid_keys
from hssbench.roofline import peak_bandwidth

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CONFIG_DIR = BENCH_DIR / "configs"
METRICS_DIR = BENCH_DIR / "metrics"

#: Top-level module names that no run may load (the JAX package is
#: `repro`; the port's `repro_torch` is another name, compared whole).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")

#: Per-process caches of the program, kept inside the checkout at fixed
#: paths so that only a cell's first run there builds.
CACHE_ENV = {
    "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
    "TRITON_CACHE_DIR": "build/triton",
    "CUDA_CACHE_PATH": "build/nv_compute_cache",
}


# -- the benchmark's data ------------------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[c['name'] for c in bench['workloads']]}")


def load_config(name: str, directory: Path = CONFIG_DIR) -> dict:
    return json.loads((directory / f"{name}.json").read_text())


def end_to_end_for(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader_path(metric: str, directory: Path = METRICS_DIR) -> Path:
    """The reader of a per-layer metric: `metrics/<name>.py`, or else the
    reader of its quantity, the name without its last dotted part (one
    reader serves `kernels.roofline_pct.card` and `.host`)."""
    for stem in (metric, metric.rsplit(".", 1)[0]):
        path = directory / f"{stem}.py"
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {metric!r} in {directory}")


def load_reader(metric: str, directory: Path = METRICS_DIR):
    path = reader_path(metric, directory)
    mod_name = "hssbench.metrics._" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that a run may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


# -- what a window leaves ---------------------------------------------------

@dataclasses.dataclass
class Reading:
    """What the per-layer readers read: the window's counts, the port's
    counters over the window and, in a traced run, the device timeline."""
    calls: int                  # calls completed in the window
    keys: int                   # keys of those
    counters: dict
    timeline: Timeline | None = None
    bandwidth: float | None = None   # the card's peak bytes/s


@dataclasses.dataclass
class Window:
    t0: float                   # perf_counter at the window's start
    t1: float                   # ... at its end (the last call returned)
    keys_done: int              # keys of the calls that completed
    done: int
    attempted: int
    failed: int
    answers: list               # (pool index, answer, counts)
    spans: list                 # (name, start_ns, end_ns) of the harness
    counters: dict
    pool: list                  # the inputs, for the reference
    timeline: Timeline | None   # traced runs on the card


class Run:
    """Everything one run needs: the configuration, the mix and the port."""

    def __init__(self, config: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, spec_overrides=None, keys=None):
        import torch

        from repro_torch.sort import SortSpec
        self.torch = torch
        self.config, self.mix = config, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.keys = int(keys if keys is not None else config["keys"])
        self.spec = SortSpec(**{**config["spec"], **(spec_overrides or {})})
        self.device = torch.device(self.spec.device)
        self.cuda = self.device.type == "cuda"
        self.capture = None

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def counters(self) -> dict:
        from repro_torch.kernels import cuda
        from repro_torch.runtime import syncs
        return {"syncs": dict(syncs.snapshot()),
                "launches": dict(cuda.launches)}

    def reset_counters(self) -> None:
        from repro_torch.kernels import cuda
        from repro_torch.runtime import syncs
        syncs.reset()
        cuda.reset_launches()

    def open_window(self) -> tuple[float, int]:
        """End the set-up: move every object made so far out of the
        collector's reach (a collection in the window then scans only
        what the window makes), start the trace (traced runs) and reset
        the counters; -> the window's start on both clocks."""
        gc.collect()
        gc.freeze()
        self.sync()
        if self.trace and self.cuda:
            self.capture = Capture()
            self.capture.start()
        self.reset_counters()
        return time.perf_counter(), time.time_ns()

    def close_trace(self, t0_ns: int, t1_ns: int) -> Timeline | None:
        if self.capture is None:
            return None
        return Timeline(self.capture.stop(), t0_ns, t1_ns)


# -- the window: one caller, back to back -----------------------------------

def direct_window(run: Run) -> Window:
    """Closed loop with one caller: `sort(x, spec)` back to back on the
    pool's arrays, each call ending when its result is usable
    (`synchronize()` for a result left on the card, the NumPy array of
    `gather` otherwise)."""
    from repro_torch.sort import gather, sort
    mix, spec = run.mix, run.spec
    pool = traffic.make_pool(mix, run.keys, run.seed, run.device)
    on_card = mix["result"] == "device"
    spans: list = []

    def call(i):
        ns0 = time.time_ns()
        out = sort(pool[i % len(pool)], spec)
        ns1 = time.time_ns()
        spans.append(("sort", ns0, ns1))
        if on_card:
            run.sync()
            spans.append(("synchronize", ns1, time.time_ns()))
            return out.shards, out.counts
        res = gather(out)
        spans.append(("gather", ns1, time.time_ns()))
        return res, out.counts

    for i in range(int(mix["warmup"])):
        call(i)
    run.sync()
    spans.clear()

    keep = traffic.Reservoir(mix["check"], run.seed)
    failed, i = 0, 0
    t0, t0_ns = run.open_window()
    end = t0 + run.seconds
    t1 = t0
    while time.perf_counter() < end:
        try:
            res = call(i)
        except Exception as e:   # a failed call counts, the loop goes on
            print(f"call {i} failed: {e!r}", file=sys.stderr)
            res = None
        t1 = time.perf_counter()
        if res is None:
            failed += 1
        else:
            keep.offer(lambda i=i, res=res: (i % len(pool), *res))
        i += 1
    t1_ns = time.time_ns()
    counters = run.counters()
    timeline = run.close_trace(t0_ns, t1_ns)
    done = i - failed
    return Window(t0, t1, done * run.keys, done, i, failed, keep.items,
                  spans, counters, pool, timeline)


# -- the end-to-end metrics (host clock) ------------------------------------

def _rate(w: Window) -> float:
    """Keys of all calls that completed over the window, from its start
    to the return of its last call."""
    return w.keys_done / (w.t1 - w.t0)


END_TO_END = {
    "card_sort_keys_per_s": _rate,
    "host_sort_keys_per_s": _rate,
}


# -- the comparison with the reference ------------------------------------

def compare(run: Run, w: Window) -> dict:
    """Compare the kept answers with the sort of their inputs, and their
    shard loads with the configuration's balance, after the window, on
    the cell's device."""
    torch = run.torch
    cmp = Comparison()
    for idx, answer, counts in w.answers:
        cmp.balance(counts.cpu(), run.keys)
        if torch.is_tensor(answer):           # shards left on the card
            answer = valid_keys(answer, counts)
        cmp.answer(torch.as_tensor(answer).to(run.device),
                   torch.as_tensor(w.pool[idx]).to(run.device))
    w.answers.clear()
    return cmp.checks(run.config["guarantees"], w.failed)


# -- one run ---------------------------------------------------------------

def _power_limit() -> str | None:
    import subprocess
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() or None


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, bench: dict | None = None,
             spec_overrides: dict | None = None,
             mix_overrides: dict | None = None,
             keys: int | None = None,
             config_dir: Path = CONFIG_DIR,
             traffic_dir: Path = traffic.TRAFFIC_DIR,
             metrics_dir: Path = METRICS_DIR) -> tuple[dict, dict]:
    """Run one cell; -> (the result line, the notes line). Overrides are
    for the tests (a tiny size on the CPU) and the control."""
    bench = bench if bench is not None else load_benchmark()
    cell = find_cell(bench, cell_name)
    config = load_config(cell["config"], config_dir)
    mix = {**traffic.load_mix(cell["traffic"], traffic_dir),
           **(mix_overrides or {})}
    run = Run(config, mix, seed, seconds, trace, spec_overrides, keys)
    torch = run.torch
    w = direct_window(run)
    setup_s = w.t0 - t_start
    timeline = w.timeline
    notes = {}
    if run.cuda:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    if timeline is not None:
        device["busy_s"] = timeline.busy_s()
        device["window_s"] = timeline.window_s
        notes["trace_capture"] = timeline.summary()

    metrics, breakdown = {}, None
    if trace:
        reading = Reading(w.done, w.keys_done, w.counters, timeline)
        if timeline is not None:
            reading.bandwidth = peak_bandwidth(device["kind"])
        for m in per_layer_for(bench, cell_name):
            value = load_reader(m["name"], metrics_dir)(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if timeline is not None:
            breakdown = {"device_ops": timeline.top_ops(10),
                         "idle_gaps": timeline.idle_by_host(
                             w.spans, "between calls")}
    else:
        for m in end_to_end_for(bench, cell_name):
            value = (setup_s if m["name"] == "setup_s"
                     else END_TO_END[m["name"]](w))
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the peak is read and the trace gone before the reference runs; only
    # the inputs and the sampled answers are left
    run.capture = None
    if run.cuda:
        torch.cuda.empty_cache()
    checks = compare(run, w)
    notes.update({"workload": cell_name, "seed": seed, "trace": int(trace),
                  "attempted": w.attempted, "done": w.done,
                  "window_s": w.t1 - w.t0, "setup_s": setup_s})
    if run.cuda:
        notes["card"] = _power_limit()
    line = {"correct": all(c["ok"] for c in checks.values()),
            "attempted": w.attempted, "failed": w.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    return line, notes


def _set_cache_env(root: Path) -> None:
    for var, rel in CACHE_ENV.items():
        os.environ[var] = str(root / rel)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="hssbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def print_checks(line: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    _set_cache_env(ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"hssbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count="
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, notes = run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=t_start, bench=bench)
    bad = forbidden_loaded()
    if bad:
        print(f"hssbench: the run loaded forbidden modules: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps({"notes": notes}, default=str))
    print(json.dumps(line))
    sys.stdout.flush()
    print_checks(line)
    return 0
