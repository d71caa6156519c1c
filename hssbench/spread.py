#!/usr/bin/env python3
"""The spreads by which the bounds in BENCHMARK.json are set: reads files
of run output (the result line is the last JSON object with "metrics" of
each run; one run per `--- <set>` header line) and prints, per set and
metric, the median and the quartile spread.

    python3 hssbench/spread.py chiprun_out/sets.log
"""
import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path

sys.path[0:1] = [str(Path(__file__).resolve().parents[1])]

from hssbench.stats import spread  # noqa: E402


def read_sets(paths):
    sets = defaultdict(lambda: defaultdict(list))
    current = "all"
    for path in paths:
        for raw in Path(path).read_text().splitlines():
            if raw.startswith("--- "):
                current = raw[4:].strip()
                continue
            if not raw.startswith("{"):
                continue
            try:
                line = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if "metrics" not in line or "correct" not in line:
                continue
            for name, m in line["metrics"].items():
                sets[current][name].append(m["value"])
            sets[current]["correct"].append(float(line["correct"]))
    return sets


def main(argv) -> int:
    for name, metrics in read_sets(argv).items():
        for metric, values in metrics.items():
            row = {"set": name, "metric": metric, "n": len(values),
                   "median": statistics.median(values), "values": values}
            if len(values) >= 2 and metric != "correct":
                row["spread"] = spread(values)
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
