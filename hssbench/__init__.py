"""hssbench: the benchmark of repro_torch, the PyTorch and CUDA port.

One run of one cell is

    python3 hssbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. `BENCHMARK.json` at the root lists the cells;
each names a configuration (`hssbench/configs/<name>.json`: the keys a
call, the SortSpec, the guarantees and the control) and a traffic mix
(`hssbench/traffic/<name>.json`, read by the one generator in
`hssbench/traffic.py`). Each per-layer metric is read by a file of its
own under `hssbench/metrics/`, found by the metric's name. So a
configuration, a mix, a cell or a metric is added with new files and
entries alone.

Everything here is the yardstick: the generators, the plain reference
(torch's sort), the spread and roofline arithmetic and the table of
peaks. Nothing here imports jax, the JAX package or `benchmarks/`; the
port (`repro_torch`) is imported only as the system under test and for
its counters.
"""
