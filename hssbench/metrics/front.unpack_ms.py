"""front.unpack_ms: stream time of the tags' unpacking a call, in ms (the
`unpack` span, open only on a tagged plan: the indices split off, the
pads trimmed and the rebase undone)."""
from hssbench.spans import stream_ms


def read(r):
    return stream_ms(r, "unpack")
