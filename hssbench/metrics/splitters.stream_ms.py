"""splitters.stream_ms: stream time of the splitter search a call, in ms
(the `splitters` span: every round, its `hss.early_exit` read and the
choice of the splitters)."""
from hssbench.spans import stream_ms


def read(r):
    return stream_ms(r, "splitters")
