"""The quartile spread by which the bounds in BENCHMARK.json were set."""
from __future__ import annotations

import statistics


def spread(values) -> float:
    """(third quartile - first quartile) / median, by
    `statistics.quantiles(values, n=4)`."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
