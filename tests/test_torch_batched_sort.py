"""The batched engine through the front door against the reference.

With the reference's own sampling draws injected, `repro_torch.sort
.sort_batched` must reproduce `repro.sort.sort_batched` bit for bit —
shards, counts, splitter keys and ranks, overflow and every SplitterStats
field — for int32, uint32 and float32 keys, ragged n, p in {1, 2, 4, 8},
B in {1, 3, 8}, and the dense and allgather exchanges. Zero tolerance.
The rest of the batched front door is in test_torch_batched_api.py.
"""
import numpy as np
import pytest

import repro_torch.sort as tsort
from torch_parity import (
    assert_batched_outputs_equal, random_keys, sort_batched_both)



@pytest.mark.parametrize("dtype,p,batch,n,exchange", [
    (np.int32, 8, 8, 2048, "dense"),
    (np.int32, 8, 8, 2048, "allgather"),
    (np.uint32, 4, 3, 2051, "dense"),
    (np.uint32, 2, 3, 2051, "allgather"),
    (np.float32, 8, 3, 4099, "allgather"),
    (np.float32, 2, 1, 2050, "dense"),
    (np.int32, 4, 1, 2051, "allgather"),
    (np.int32, 1, 3, 2051, "dense"),
    (np.float32, 1, 8, 1000, "allgather"),
])
def test_sort_batched_matches_reference(dtype, p, batch, n, exchange):
    xs = random_keys(dtype, (batch, n), seed=p * 10 + batch)
    got, want = sort_batched_both(xs, p, exchange=exchange)
    assert isinstance(got, tsort.BatchedSortOutput)
    assert_batched_outputs_equal(got, want)
    for b in range(batch):
        np.testing.assert_array_equal(got.gather(b), np.sort(xs[b]))
    assert [g.shape for g in got.gather_all()] == [(n,)] * batch
