"""kernels.merge_roofline_pct: the post-exchange merge's least time over
its stream time, in percent.

The least work of the merge, whatever implements it, is one read and one
write of every key at the caller's 4 bytes (the cells' keys are int32):
2 * 4 bytes a key, counted from the window's keys alone, at the card's
peak bandwidth (`hssbench/peaks.json`). Its time is the `merge` span's
stream time (`exchange.merge_ms`). A merge of int64 keys (a tagged pack)
moves 8 bytes a key each way, so a perfect one reads at most 50 %; a merge
of pairwise levels, ceil(log2 p) passes, reads less again."""
from hssbench.spans import stream_ms

KEY_BYTES = 4


def read(r):
    if r.bandwidth is None or r.calls == 0 or r.keys == 0:
        return None
    ms = stream_ms(r, "merge")
    if not ms:
        return None
    least_s = 2 * KEY_BYTES * (r.keys / r.calls) / r.bandwidth
    return 100.0 * least_s / (ms / 1e3)
