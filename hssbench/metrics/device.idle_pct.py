"""device.idle_pct: share of the traced window in which no kernel, copy
or memset ran on the card, in percent."""


def read(r):
    if r.timeline is None or r.timeline.window_s <= 0 or not r.timeline.events:
        return None
    return 100.0 * (1.0 - r.timeline.busy_s() / r.timeline.window_s)
