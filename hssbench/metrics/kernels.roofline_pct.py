"""kernels.roofline_pct: the least time sorting the window's keys needs
(`hssbench.roofline`: 3 passes, each reading and writing every key once,
at the card's peak bandwidth) over the device time of all kernels in the
traced window, in percent. Copies and memsets are left out: the front
door's metrics have them. Served pad rows are not counted as keys."""
from hssbench.roofline import roofline_pct


def read(r):
    if r.timeline is None or r.bandwidth is None or r.keys == 0:
        return None
    return roofline_pct(r.keys, r.timeline.seconds("kernel"), r.bandwidth)
