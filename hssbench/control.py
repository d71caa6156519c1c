#!/usr/bin/env python3
"""The control of a cell: the cell's run with the configuration's
`control.spec` in the program's place (a path of the program that breaks
a guarantee the configuration states), on several seeds in one process.
Its `correct` has to read false; the numbers it reads are the upper
readings the limits were set below.

    python3 hssbench/control.py --workload sort.card_unif \\
        --seeds 11,12,13 --seconds 5
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from hssbench import harness  # noqa: E402


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness._set_cache_env(ROOT)
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    control = harness.load_config(cell["config"])["control"]["spec"]
    for seed in (int(s) for s in args.seeds.split(",")):
        line, notes = harness.run_cell(
            args.workload, seed, args.seconds, False,
            t_start=time.perf_counter(), bench=bench,
            spec_overrides=control)
        print(json.dumps({"control": control, "seed": seed,
                          "correct": line["correct"],
                          "checks": line["checks"],
                          "failed": line["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
