"""Deterministic synthetic LM data pipeline (the port's copy of
repro.data.synthetic; NumPy only).

Produces (tokens, labels) batches from a seeded counter — reproducible across
restarts given the step cursor, which is exactly what the checkpoint manifest
stores. A Zipf-ish marginal over the vocab plus a short Markov
mixing step make the stream non-trivial for sanity-checking loss curves while
remaining fully deterministic and offline.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int):
        """Return (tokens, labels) uint32 arrays of shape (batch, seq)."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, s, v = self.global_batch, self.seq_len, self.vocab
        # Zipf marginal via inverse-CDF on a power law, clipped to vocab.
        u = rng.random((b, s + 1))
        toks = np.minimum((u ** -1.3).astype(np.int64), v - 1)
        # short-range structure: every 4th token repeats its predecessor + 1
        toks[:, 3::4] = (toks[:, 2::4] + 1) % v
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return tokens, labels

    def doc_lengths(self, step: int, n_docs: int) -> np.ndarray:
        """Document lengths for the packing/bucketing pipeline (log-normal)."""
        rng = np.random.default_rng((self.seed << 21) ^ step)
        ln = rng.lognormal(mean=5.5, sigma=1.0, size=n_docs)
        return np.clip(ln, 16, self.seq_len).astype(np.int32)
