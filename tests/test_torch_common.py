"""The port's substrate against the reference: common, tagging, the uint32
flip, the Comm seam, the distributions copy, and the port's boundaries
(no jax/repro imports, the card as default device, unported options and
refused ones)."""
import ast
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.common as rc
import repro.core.tagging as rt
import repro_torch.core.common as tc
import repro_torch.core.tagging as tt
import repro.sort as rsort
import repro_torch.sort as tsort
from repro.data import distributions as rdist
from repro_torch.data import distributions as tdist
from repro_torch.parallel.comm import Comm
from torch_parity import assert_bits_equal

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- common
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
def test_sentinels_match_reference(dtype):
    np_dt = {torch.int32: np.int32, torch.uint32: np.uint32,
             torch.float32: np.float32}[dtype]
    assert tc.hi_sentinel(dtype) == np.asarray(rc.hi_sentinel(np_dt)).item()
    assert tc.lo_sentinel(dtype) == np.asarray(rc.lo_sentinel(np_dt)).item()


def test_small_math_matches_reference():
    for n in [1, 2, 3, 7, 8, 9, 1000, 2 ** 21 + 1]:
        for m in [1, 8, 512]:
            assert tc.round_up(n, m) == rc.round_up(n, m)
            assert tc.cdiv(n, m) == rc.cdiv(n, m)
        assert tc.pow2_ceil(n) == rc.pow2_ceil(n)
    for p in [1, 2, 4, 8, 64, 4096]:
        for eps in [0.01, 0.05, 0.2]:
            assert tc.auto_rounds(p, eps) == rc.auto_rounds(p, eps)
            assert tc.final_sampling_ratio(p, eps) == \
                rc.final_sampling_ratio(p, eps)
            k = rc.auto_rounds(p, eps)
            np.testing.assert_array_equal(tc.sampling_ratios(p, eps, k),
                                          rc.sampling_ratios(p, eps, k))


@pytest.mark.parametrize("kw", [{}, {"eps": 0.01}, {"rounds": 2},
                                {"sample_per_shard": 20},
                                {"capacity_scale": 3.0, "eps": 0.2}])
def test_hss_config_sizing_matches_reference(kw):
    for p in [2, 8, 64]:
        assert tc.HSSConfig(**kw).resolved_rounds(p) == \
            rc.HSSConfig(**kw).resolved_rounds(p)
        assert tc.HSSConfig(**kw).resolved_sample_cap(p) == \
            rc.HSSConfig(**kw).resolved_sample_cap(p)


def test_weak_scaling_sizing():
    """The sizes the H100 run uses (paper_sort.WEAK_SCALING at p = 8)."""
    cfg = tc.HSSConfig(eps=0.05)
    assert cfg.resolved_rounds(8) == 4
    assert cfg.resolved_sample_cap(8) == 32


def test_interval_union_size_matches_reference(rng):
    for _ in range(20):
        lo = np.sort(rng.integers(0, 1000, 7)).astype(np.int32)
        hi = np.maximum(lo, np.sort(rng.integers(0, 1000, 7))
                        ).astype(np.int32)
        want = rc.interval_union_size(jnp.asarray(lo), jnp.asarray(hi))
        got = tc.interval_union_size(torch.from_numpy(lo),
                                     torch.from_numpy(hi))
        assert_bits_equal(got, want)


# --------------------------------------------------------------- tagging
def _float_corpus(rng):
    fi = np.finfo(np.float32)
    special = np.array([0.0, -0.0, 1.0, -1.0, fi.max, fi.min, fi.tiny,
                        -fi.tiny, np.inf, -np.inf, 1e-45, -1e-45],
                       np.float32)
    return np.concatenate([special,
                           (rng.standard_normal(2000) * 1e6
                            ).astype(np.float32)])


def test_float32_bijection_matches_reference(rng):
    x = _float_corpus(rng)
    want = rt.float32_to_sortable_int32(jnp.asarray(x))
    got = tt.float32_to_sortable_int32(torch.from_numpy(x))
    assert_bits_equal(got, want)
    back = tt.sortable_int32_to_float32(got)
    assert_bits_equal(back, x)
    assert_bits_equal(back, rt.sortable_int32_to_float32(want))


def test_float32_bijection_preserves_order(rng):
    x = _float_corpus(rng)
    x = np.concatenate([[-0.0], np.sort(x[x != 0]), [0.0]]).astype(np.float32)
    x = np.sort(x, kind="stable")     # -0.0 before +0.0, as encoded
    enc = tt.float32_to_sortable_int32(torch.from_numpy(x)).numpy()
    assert np.all(np.diff(enc.astype(np.int64)) >= 0)


def test_uint32_flip_preserves_order_and_round_trips(rng):
    x = np.concatenate([np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                                 np.uint32),
                        rng.integers(0, 2 ** 32, 3000, dtype=np.uint32)])
    enc = tt.uint32_to_sortable_int32(torch.from_numpy(x))
    assert enc.dtype == torch.int32
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(np.argsort(enc.numpy(), kind="stable"),
                                  order)
    back = tt.sortable_int32_to_uint32(enc)
    np.testing.assert_array_equal(back.view(torch.int32).numpy()
                                  .view(np.uint32), x)


def test_tag_bits_matches_reference():
    for p in [1, 2, 8]:
        for n_local in [1, 2, 1000, 2_000_000]:
            assert tt.tag_bits(p, n_local) == rt.tag_bits(p, n_local)


# ------------------------------------------------------------------ comm
def test_comm_collectives_and_log(rng):
    p = 4
    comm = Comm(p)
    x = torch.from_numpy(rng.integers(0, 100, (p, 3, 2)).astype(np.int32))
    np.testing.assert_array_equal(comm.all_gather(x).numpy(), x.numpy())
    s = comm.psum(x)
    assert s.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), x.numpy().sum(0))
    y = torch.arange(p * p * 5, dtype=torch.int32).reshape(p, p, 5)
    np.testing.assert_array_equal(comm.all_to_all(y).numpy(),
                                  y.numpy().transpose(1, 0, 2))
    np.testing.assert_array_equal(comm.axis_index().numpy(), np.arange(p))
    assert dict(comm.log) == {"all_gather": 1, "psum": 1, "all_to_all": 1}
    with pytest.raises(ValueError):
        comm.psum(torch.zeros((p + 1, 2)))


# --------------------------------------------------------- distributions
@pytest.mark.parametrize("name", sorted(tdist.DISTRIBUTIONS))
def test_distribution_copy_matches_reference(name):
    np.testing.assert_array_equal(tdist.make_distribution(name, 999, seed=2),
                                  rdist.make_distribution(name, 999, seed=2))


@pytest.mark.parametrize("name", sorted(tdist.ADVERSARIAL))
def test_adversarial_copy_matches_reference(name):
    np.testing.assert_array_equal(tdist.make_adversarial(name, 999, seed=2),
                                  rdist.make_adversarial(name, 999, seed=2))


# ------------------------------------------------------------ boundaries
def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    """AST walk over every module of src/repro_torch/ and chip_smoke.py."""
    banned = ("jax", "jaxlib", "repro")
    files = _port_files()
    assert len(files) > 20
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"src/repro_torch/sort/grouping.py", "src/repro_torch/sort/api.py",
            "src/repro_torch/core/exchange.py",
            "src/repro_torch/core/splitters.py"} <= names
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    assert tsort.SortSpec().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsort.sort(np.arange(64, dtype=np.int32))


def test_unported_options_raise_not_implemented():
    """Every reference algorithm and exchange is ported: unknown names, an
    unknown overflow policy and an unsupported key dtype are refused as
    the reference refuses them."""
    x = np.arange(64, dtype=np.int32)
    with pytest.raises(ValueError, match="unknown exchange"):
        tsort.sort(x, tsort.SortSpec(device="cpu", exchange="mpi"))
    with pytest.raises(ValueError, match="unknown sort algorithm"):
        tsort.sort(x, tsort.SortSpec(device="cpu", algorithm="radix"))
    assert tsort.available_algorithms() == tuple(sorted(rsort.ALGORITHMS))
    assert tsort.ALGORITHMS == rsort.ALGORITHMS
    with pytest.raises(ValueError, match="on_overflow"):
        tsort.SortSpec(on_overflow="drop")
    with pytest.raises(ValueError, match="on_overflow"):
        rsort.SortSpec(on_overflow="drop")
    with pytest.raises(ValueError, match="unsupported"):
        tsort.sort(x.astype(np.float16), tsort.SortSpec(device="cpu"))
    with pytest.raises(ValueError, match="unsupported"):
        rsort.sort(x.astype(np.float16), rsort.SortSpec())


def test_sentinel_keys_force_tagging():
    """dtype-max keys collide with the padding sentinel: tagging keeps
    them as data (or tag=False refuses), as in the reference."""
    top = 2 ** 31 - 1
    x = np.array([top - 5, top, top - 3, top, top - 9], np.int32)
    out = tsort.sort(x, tsort.SortSpec(device="cpu", shards=2))
    assert out.indices is not None
    np.testing.assert_array_equal(out.gather(), np.sort(x))
    with pytest.raises(ValueError):
        tsort.sort(x, tsort.SortSpec(device="cpu", shards=2, tag=False))
    assert math.isinf(tc.hi_sentinel(torch.float32))
