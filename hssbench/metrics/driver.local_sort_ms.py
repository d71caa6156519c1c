"""driver.local_sort_ms: stream time of the shard rows' local sort a
call, in ms (the `local_sort` span)."""
from hssbench.spans import stream_ms


def read(r):
    return stream_ms(r, "local_sort")
