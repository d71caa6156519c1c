"""multistage.stage2_ms: stream time of the two-stage sort's second stage a
call, in ms (the `stage2` span: from the fold of the stage-1 rows to the
final unfold, the splitter rounds within each group and the exchange
along the inner axis, merge included). None on a port without the
span."""
from hssbench.spans import stream_ms


def read(r):
    return stream_ms(r, "stage2")
