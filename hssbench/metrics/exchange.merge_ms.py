"""exchange.merge_ms: stream time of the k-way merge of the received runs
a call, in ms (the `merge` span)."""
from hssbench.spans import stream_ms


def read(r):
    return stream_ms(r, "merge")
