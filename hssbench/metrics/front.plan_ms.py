"""front.plan_ms: stream time of the adapter plan a call, in ms (the `plan`
span: to_core, the key range, the duplicate check, the `plan.probe`
copy)."""
from hssbench.spans import stream_ms


def read(r):
    return stream_ms(r, "plan")
