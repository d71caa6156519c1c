"""multistage.stage1_ms: stream time of the two-stage sort's first stage a
call, in ms (the `stage1` span: the split into r1 groups, its splitter
rounds over all p shards and its exchange along the outer axis, merge
included). None on a port without the span."""
from hssbench.spans import stream_ms


def read(r):
    return stream_ms(r, "stage1")
