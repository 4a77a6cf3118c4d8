"""The generators of training traffic, as sources the port's `ShardedLoader`
takes: token ids (`TokenFeed`) and the frames of an audio encoder's stubbed
front end (`FrameFeed`). A reference module names the one its model reads
(``FEED``), and `for_cell` builds it from the reference's sizes, the
traffic mix and the seed.

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

    @classmethod
    def for_cell(cls, dims: dict, traffic: dict, seed: int) -> "TokenFeed":
        return cls(dims["vocab"], traffic["seq_len"], seed)

    def batch(self, step: int, shard: int, n_shards: int,
              batch_per_shard: int) -> Dict[str, np.ndarray]:
        from portbench.trace import span
        with span("batch"):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, shard]))
            ids = log_uniform(rng, self.vocab,
                              (batch_per_shard, self.seq_len + 1))
            return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


class FrameFeed:
    """``features``: rows of ``seq_len`` fp32 frames of ``width``, N(0, 1);
    ``labels``: one unit a frame, uniform over ``vocab`` (k-means units are
    far flatter than text's ids).

    The frames come from a bank of ``rows`` rows drawn once from the seed;
    a batch is the bank's rows from an offset drawn from (seed, step,
    shard), a view of the bank. Drawing each step's frames anew would run
    on the host while the card waits on the trainer's loss, the benchmark's
    work charged to the program: 450 ms for 16 rows of 2,048 x 512 frames
    (float64 normals cast to fp32, on an H100 machine's host), where a
    view takes 0.3 ms."""

    def __init__(self, width: int, vocab: int, seq_len: int, rows: int,
                 seed: int):
        self.vocab, self.seq_len = vocab, seq_len
        self.seed = seed % 2 ** 64
        rng = np.random.default_rng(np.random.SeedSequence([self.seed]))
        self.bank = rng.standard_normal((rows, seq_len, width),
                                        dtype=np.float32)

    @classmethod
    def for_cell(cls, dims: dict, traffic: dict, seed: int) -> "FrameFeed":
        return cls(dims["frontend_dim"], dims["vocab"], traffic["seq_len"],
                   2 * traffic["global_batch"], seed)

    def batch(self, step: int, shard: int, n_shards: int,
              batch_per_shard: int) -> Dict[str, np.ndarray]:
        from portbench.trace import span
        with span("batch"):
            rows = self.bank.shape[0]
            if batch_per_shard > rows:
                raise ValueError(f"a batch of {batch_per_shard} rows from a "
                                 f"bank of {rows}")
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, shard]))
            at = int(rng.integers(0, rows - batch_per_shard + 1))
            labels = rng.integers(0, self.vocab,
                                  (batch_per_shard, self.seq_len),
                                  dtype=np.int32)
            return {"features": self.bank[at:at + batch_per_shard],
                    "labels": labels}
