"""front.pack_ms: stream time of the implicit tags' packing a call, in ms
(the `pack` span, open only on a tagged plan: the rebase, the pads and
(key << b) | index in the pack dtype)."""
from hssbench.spans import stream_ms


def read(r):
    return stream_ms(r, "pack")
