#!/usr/bin/env python3
"""Run one cell of the benchmark from the root of a checkout:

    python3 hssbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs a CUDA card (it exits 2 and prints no result without one) and
the port under `src/`. See `hssbench/harness.py`."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for `hssbench`) and `src` (for the port) replace
# this script's own directory, whose modules are not top-level names
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from hssbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))
