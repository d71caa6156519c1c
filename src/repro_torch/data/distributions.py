"""The paper's input distributions (Section 7.2, Figure 5).

The port's own copy of `repro.data.distributions` (numpy only), so that
`repro_torch` needs nothing of the JAX package. Same generators, same
seeds, same arrays.

  UNIF      uniform over the full int range used
  SKEW1     half uniform over the range, half uniform over a window of 1000
  SKEW2     uniform over [0, 100] (massive duplication)
  SKEW3     bitwise AND of two uniform keys (skew toward zero bits)
  GAUSS     Gaussian
  AllZeros  all keys identical

All return int32 numpy arrays (nonnegative, < 2**30 so tagging headroom
exists). Duplicates are intentional for SKEW2/AllZeros — run through
repro.core.tagging before sorting, exactly as the paper prescribes.

ADVERSARIAL extends the family with inputs crafted to break sample-based
partitioning (DESIGN.md Section 9): degenerate key sets that starve the
splitter search, orderings that defeat naive sampling, and heavy-hitter
pileups that force the duplicate-handling path. All but DTYPE_EXTREME
stay in the same nonnegative < 2**30 envelope; DTYPE_EXTREME
deliberately hits the dtype's min/max/±0.0 corners (use it with the
float/negative-int adapters, not with the raw tagging pack).
"""
from __future__ import annotations

import numpy as np

_RANGE = 2 ** 30


def _unif(rng, n):
    return rng.integers(0, _RANGE, size=n)


def _skew1(rng, n):
    a = rng.integers(0, _RANGE, size=n // 2)
    b = rng.integers(_RANGE // 3, _RANGE // 3 + 1000, size=n - n // 2)
    out = np.concatenate([a, b])
    rng.shuffle(out)
    return out


def _skew2(rng, n):
    return rng.integers(0, 101, size=n)


def _skew3(rng, n):
    return rng.integers(0, _RANGE, size=n) & rng.integers(0, _RANGE, size=n)


def _gauss(rng, n):
    x = rng.standard_normal(n) * (_RANGE / 8) + _RANGE / 2
    return np.clip(x, 0, _RANGE - 1).astype(np.int64)


def _allzeros(rng, n):
    return np.zeros(n, np.int64)


DISTRIBUTIONS = {
    "UNIF": _unif,
    "SKEW1": _skew1,
    "SKEW2": _skew2,
    "SKEW3": _skew3,
    "GAUSS": _gauss,
    "AllZeros": _allzeros,
}


def make_distribution(name: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return DISTRIBUTIONS[name](rng, n).astype(np.int32)


# -- adversarial family (DESIGN.md Section 9) -----------------------------

def _all_equal(rng, n):
    # one giant duplicate class: every splitter candidate is the same key,
    # so an untagged partitioner piles the whole input onto one shard
    return np.full(n, _RANGE // 3, np.int64)


def _presorted(rng, n):
    # already globally sorted: regular sampling sees a perfectly smooth
    # CDF, but the exchange must still move ~nothing — a degenerate
    # routing pattern worth auditing
    return np.linspace(0, _RANGE - 1, n).astype(np.int64)


def _reverse(rng, n):
    return _presorted(rng, n)[::-1].copy()


def _sawtooth(rng, n, period: int = 64):
    # p-periodic ramp: with sample stride ≈ period the regular sampler can
    # alias onto a single phase and pick pathological splitters
    return (np.arange(n, dtype=np.int64) % period) * (_RANGE // period)


def _zipf_hh(rng, n):
    # zipf(1.3) heavy hitters: a handful of keys own most of the mass but
    # a long distinct tail keeps the splitter search honest
    z = rng.zipf(1.3, size=n)
    return np.minimum(z, _RANGE - 1)


def _dtype_extreme(rng, n, dtype=np.int32):
    """Clusters at the dtype's representational corners.

    int dtypes: iinfo.min / -1 / 0 / +1 / iinfo.max. float dtypes:
    -inf-adjacent min, -1.0, -0.0, +0.0, +1.0, max. Exercises sentinel
    padding, sign handling, and total-order encoding end to end."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        fi = np.finfo(dt)
        corners = np.array([fi.min, -1.0, -0.0, 0.0, 1.0, fi.max], dt)
    else:
        ii = np.iinfo(dt)
        corners = np.array([ii.min, -1, 0, 1, ii.max], dt)
    out = corners[rng.integers(0, len(corners), size=n)]
    return out


ADVERSARIAL = {
    "ALL_EQUAL": _all_equal,
    "PRESORTED": _presorted,
    "REVERSE": _reverse,
    "SAWTOOTH": _sawtooth,
    "ZIPF_HH": _zipf_hh,
    "DTYPE_EXTREME": _dtype_extreme,
}


def make_adversarial(name: str, n: int, seed: int = 0,
                     dtype=np.int32) -> np.ndarray:
    """Generate one adversarial input. All names return int32 except
    DTYPE_EXTREME, which returns the requested `dtype` (and is the only
    member allowed to leave the nonnegative < 2**30 tagging envelope)."""
    rng = np.random.default_rng(seed)
    fn = ADVERSARIAL[name]
    if name == "DTYPE_EXTREME":
        return fn(rng, n, dtype=dtype)
    return fn(rng, n).astype(np.int32)
