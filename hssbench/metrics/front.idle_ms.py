"""front.idle_ms: device idle time inside the adapter plan a call, in ms
(the traced timeline's gaps whose midpoint lies in a `plan` span: the
`plan.probe` copy drains the stream)."""
from hssbench.spans import idle_ms


def read(r):
    return idle_ms(r, "plan")
