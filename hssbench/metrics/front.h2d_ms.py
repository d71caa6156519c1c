"""front.h2d_ms: host-to-device copy time a call, in ms (`Memcpy HtoD`
device time in the traced window over the calls completed in it; 0 in a
traced window with no such copy)."""


def read(r):
    if r.timeline is None or r.calls == 0:
        return None
    return 1e3 * r.timeline.seconds("memcpy_htod") / r.calls
