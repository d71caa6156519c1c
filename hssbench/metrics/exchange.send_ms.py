"""exchange.send_ms: the exchange's self time a call, in ms: the
`exchange` span's stream time less its `merge` child's (the slices, the
dense send and the psums)."""
from hssbench.spans import self_ms


def read(r):
    return self_ms(r, "exchange")
