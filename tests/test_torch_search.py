"""K4s, the probe-rank search over sorted rows, against the Pallas kernels.

`probe_ranks_search_plain` (the 32-ary schedule K4s runs on the card, in
torch ops) is held with zero tolerance to the reference's
`probe_ranks_pallas` (Pallas #5) and `probe_ranks_batched_pallas` (#6) in
interpret mode, the keys sorted and padded as the reference's
`histogram/ops.py:17` pads them, and to the counting K4's plain version.
The cases cover row lengths on both sides of a warp (31, 32, 33) and past
one and three pivot levels (1,000 and 100,003 keys), duplicates, probes
drawn from the keys or outside their range, INT_MIN keys and the INT_MAX
pad. Also here: the policy layer sends `assume_sorted=True` to the search
and `assume_sorted=False` to the count.

The CUDA kernel itself is held to this plain version by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as rd
from repro.kernels.histogram import ops as rhops
from repro_torch.kernels import dispatch as td
from repro_torch.kernels.histogram import kernel as thk

I32 = np.iinfo(np.int32)
ROWS = 3
KINDS = ["uniform", "dups", "all_equal", "probes_from_keys",
         "out_of_range", "int_min", "int_max_pad"]


def _t(x):
    """A reference result as a torch tensor (copied: jax's are read-only)."""
    return torch.from_numpy(np.array(x))


def _case(rng, n, m, kind):
    """(ROWS, n) keys sorted per row and (ROWS, m) probes, both int32."""
    def wide(shape):
        return rng.integers(I32.min, I32.max, size=shape, dtype=np.int64)

    if kind == "dups":
        keys, probes = rng.integers(0, 8, (ROWS, n)), rng.integers(
            -1, 9, (ROWS, m))
    elif kind == "all_equal":
        keys, probes = np.full((ROWS, n), 5), rng.integers(4, 7, (ROWS, m))
    elif kind == "probes_from_keys":
        keys = wide((ROWS, n))
        probes = np.take_along_axis(keys, rng.integers(0, n, (ROWS, m)), 1)
    elif kind == "out_of_range":
        keys = rng.integers(-1000, 1001, (ROWS, n))
        probes = np.where(rng.random((ROWS, m)) < 0.5,
                          rng.integers(I32.min, -1000, (ROWS, m)),
                          rng.integers(1001, I32.max, (ROWS, m)))
    elif kind == "int_min":
        keys = wide((ROWS, n))
        keys[:, : (n + 2) // 3] = I32.min
        probes = wide((ROWS, m))
        probes[:, ::2] = I32.min
        probes[:, 1::4] = I32.min + 1
    elif kind == "int_max_pad":
        keys = wide((ROWS, n))
        keys[:, n - n // 4:] = I32.max
        probes = wide((ROWS, m))
        probes[:, m - (m + 1) // 2:] = I32.max
    else:
        keys, probes = wide((ROWS, n)), wide((ROWS, m))
    return (np.sort(keys, axis=-1).astype(np.int32),
            probes.astype(np.int32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [1, 7, 256])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 100_003])
def test_search_plain_matches_pallas(rng, n, m, kind):
    keys, probes = _case(rng, n, m, kind)
    got = thk.probe_ranks_search_plain(torch.from_numpy(keys),
                                       torch.from_numpy(probes))
    assert got.dtype == torch.int32
    # Pallas #6: a distinct probe row per key row
    want = rhops.probe_ranks_batched(jnp.asarray(keys), jnp.asarray(probes),
                                     interpret=True)
    assert torch.equal(got, _t(want))
    # Pallas #5: one row, one probe vector
    want0 = rhops.probe_ranks(jnp.asarray(keys[0]), jnp.asarray(probes[0]),
                              interpret=True)
    assert torch.equal(got[0], _t(want0))
    # the counting K4's plain version on the same (sorted) rows
    assert torch.equal(got, thk.probe_ranks_plain(torch.from_numpy(keys),
                                                  torch.from_numpy(probes)))


@pytest.mark.parametrize("n,levels", [(1, 0), (32, 0), (33, 1), (1024, 1),
                                      (1025, 2), (250_000, 3),
                                      (2_000_000, 4)])
def test_search_levels(n, levels):
    """Pivot levels before the last read: the main paths' 250,000- and
    2,000,000-key rows take 4 and 5 dependent reads in all."""
    assert thk.search_levels(n) == levels


@pytest.mark.parametrize("assume_sorted", [True, False])
def test_kernel_policy_routes_by_assume_sorted(rng, monkeypatch,
                                               assume_sorted):
    """On the CPU under "kernel", sorted rows reach the search's plain
    version and unsorted ones the count's; both equal the reference's
    "xla" policy."""
    calls = []
    for name in ("probe_ranks_search_plain", "probe_ranks_plain"):
        real = getattr(thk, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(thk, name, spy)
    keys, probes = _case(rng, 1500, 40, "dups")
    if not assume_sorted:
        keys = rng.permuted(keys, axis=-1)
    got = td.probe_ranks(torch.from_numpy(keys), torch.from_numpy(probes),
                         policy="kernel", assume_sorted=assume_sorted)
    assert calls == ["probe_ranks_search_plain" if assume_sorted
                     else "probe_ranks_plain"]
    for r in range(ROWS):
        want = rd.probe_ranks(jnp.asarray(keys[r]), jnp.asarray(probes[r]),
                              policy="xla", assume_sorted=assume_sorted)
        assert torch.equal(got[r], _t(want))


def test_search_wrapper_edges_and_arguments():
    empty = thk.probe_rank_search(torch.zeros((2, 0), dtype=torch.int32),
                                  torch.ones((2, 5), dtype=torch.int32))
    assert torch.equal(empty, torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(TypeError):
        thk.probe_rank_search(torch.zeros((1, 8), dtype=torch.int64),
                              torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        thk.probe_rank_search(torch.zeros((2, 8), dtype=torch.int32),
                              torch.zeros((3, 2), dtype=torch.int32))
