"""kernels.local_sort_roofline_pct: the shard rows' local sort's least time
over its stream time, in percent.

The least work of the local sort, whatever sorts the rows, is one read
and one write of every key at the cells' 4 bytes: 2 * 4 bytes a key,
counted from the window's keys alone, at the card's peak bandwidth
(`hssbench/peaks.json`). Its time is the `local_sort` span's stream time
(`driver.local_sort_ms`). The count does not depend on the route or the
kernels, so no change of either can take the share past 100 %."""
from hssbench.spans import stream_ms

KEY_BYTES = 4


def read(r):
    if r.bandwidth is None or r.calls == 0 or r.keys == 0:
        return None
    ms = stream_ms(r, "local_sort")
    if not ms:
        return None
    least_s = 2 * KEY_BYTES * (r.keys / r.calls) / r.bandwidth
    return 100.0 * least_s / (ms / 1e3)
