"""splitters.rounds: splitter rounds a call, from the port's
`runtime.syncs` count of `hss.early_exit` (one entry a round that ran)."""


def read(r):
    n = r.counters["syncs"].get("hss.early_exit", 0)
    if r.calls == 0 or n == 0:
        return None
    return n / r.calls
