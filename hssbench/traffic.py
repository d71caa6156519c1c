"""The one traffic generator: it reads a mix (`traffic/<name>.json`) and
the run's seed, and gives the inputs.

A mix has these keys, and no others (`load_mix` refuses a key it does
not read):

  distribution  a name of `hssbench.distributions.DISTRIBUTIONS`.
  pool          distinct input arrays made in set-up; calls cycle through
                them.
  input         "device" (the pool sits on the card) or "host" (NumPy).
  result        "device" (the output stays on the card; the call ends in
                `synchronize()`) or "gather" (`repro_torch.sort.gather`,
                a NumPy array).
  warmup        warm calls before the window.
  check         answers compared with the reference after the window,
                drawn from the seed.

The configuration gives the keys a call, so every seed gets the same
work: the same sizes, other keys.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from hssbench.distributions import DISTRIBUTIONS, make_keys

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
SEED_MOD = 2 ** 64
CHOICES = {"input": ("device", "host"), "result": ("device", "gather")}
MIX_KEYS = {"distribution", "pool", "warmup", "check", *CHOICES}


def load_mix(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    mix = json.loads((directory / f"{name}.json").read_text())
    if set(mix) != MIX_KEYS:
        raise ValueError(f"mix {name}: keys {sorted(mix)}; the generator "
                         f"reads exactly {sorted(MIX_KEYS)}")
    if mix["distribution"] not in DISTRIBUTIONS:
        raise ValueError(f"mix {name}: unknown distribution "
                         f"{mix['distribution']!r}")
    for key, allowed in CHOICES.items():
        if mix[key] not in allowed:
            raise ValueError(f"mix {name}: {key} {mix[key]!r} is none of "
                             f"{allowed}")
    return mix


def stream_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of a run's seed (pool entry k is
    stream k; the checks have a stream of their own)."""
    ss = np.random.SeedSequence([int(seed) % SEED_MOD, stream])
    return int(ss.generate_state(1, np.uint64)[0])


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


POOL_STREAM = 0
CHECK_STREAM = 1 << 20


def make_pool(mix: dict, n: int, seed: int, device) -> list:
    """The mix's input arrays of `n` keys each, made on `device` from the
    seed; NumPy arrays where the mix's input is "host"."""
    pool = [make_keys(mix["distribution"], n,
                      stream_seed(seed, POOL_STREAM + k), device)
            for k in range(int(mix["pool"]))]
    if mix["input"] == "host":
        pool = [a.cpu().numpy() for a in pool]
    return pool


class Reservoir:
    """A uniform sample of `k` items over a stream of unknown length,
    drawn from the seed (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.items: list = []
        self.seen = 0
        self._rng = rng(seed, CHECK_STREAM)

    def offer(self, item_fn) -> None:
        """Offer the next item; `item_fn()` makes it only when kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item_fn())
            return
        j = int(self._rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item_fn()
