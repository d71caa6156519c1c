"""The least work a sort needs, whatever implements it, and the card's
published peaks (`peaks.json`).

HSS makes three passes over the keys: the local sort, the exchange and
the merge of the p runs. Each has to read and write every key at least
once, so a call on N int32 keys moves at least 3 * 2 * N * 4 bytes. The least time is that over the card's peak
bandwidth. It is counted from N alone, so no fusion, deletion or
replacement of kernels can take a share of it past 100 %; it is also a
floor that no comparison network reaches (each bitonic stage is a pass).
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"
PASSES = 3
KEY_BYTES = 4


def least_bytes(n_keys: int) -> int:
    """Bytes that sorting `n_keys` int32 keys moves at the least."""
    return PASSES * 2 * int(n_keys) * KEY_BYTES


def peak_bandwidth(device_name: str) -> float:
    """Bytes per second of the card named `device_name`
    (`torch.cuda.get_device_name()`), from the table of peaks."""
    table = json.loads(PEAKS.read_text())
    for part, row in table.items():
        if part in device_name:
            return float(row["hbm_bytes_per_s"])
    raise KeyError(f"no peak for device {device_name!r} in {PEAKS}")


def roofline_pct(n_keys: int, kernel_seconds: float,
                 bandwidth: float) -> float | None:
    """Least time of sorting `n_keys` keys over the kernels' device time,
    in percent; None when no kernel ran."""
    if kernel_seconds <= 0:
        return None
    return 100.0 * least_bytes(n_keys) / bandwidth / kernel_seconds
