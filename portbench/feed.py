"""The one generator of training traffic: token ids drawn from the seed, as
a source the port's `ShardedLoader` takes.

Each batch is a pure function of (seed, step, shard), so the reference
draws the very batches the program trained on.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def log_uniform(rng: np.random.Generator, vocab: int, shape) -> np.ndarray:
    """id = floor(V^u) - 1, u uniform: a heavy head, as text's ids have
    (P(id = k) ∝ log((k + 2) / (k + 1)))."""
    ids = np.floor(np.power(float(vocab), rng.random(shape))) - 1
    return np.clip(ids, 0, vocab - 1).astype(np.int32)


class TokenFeed:
    """Rows of ``seq_len + 1`` ids; ``tokens`` are the first ``seq_len``,
    ``labels`` the last."""

    def __init__(self, vocab: int, seq_len: int, seed: int):
        self.vocab, self.seq_len = vocab, seq_len
        self.seed = seed % 2 ** 64

    def batch(self, step: int, shard: int, n_shards: int,
              batch_per_shard: int) -> Dict[str, np.ndarray]:
        from portbench.trace import span
        with span("batch"):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, shard]))
            ids = log_uniform(rng, self.vocab,
                              (batch_per_shard, self.seq_len + 1))
            return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
