"""splitters.idle_ms: device idle time inside the splitter search a call,
in ms (the traced timeline's gaps whose midpoint lies in a `splitters`
span: the rounds' `hss.early_exit` reads drain the stream)."""
from hssbench.spans import idle_ms


def read(r):
    return idle_ms(r, "splitters")
