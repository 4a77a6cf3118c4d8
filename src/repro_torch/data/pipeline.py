"""Deterministic, shard-aware, RESUMABLE data pipeline — a copy of the JAX
package's `data/pipeline.py` (numpy only; the port imports nothing of
that package): the token, CIFAR-shaped image and audio-frame sources,
each keyed as the reference keys it.

Transient training needs the data stream to be a pure function of
(seed, step, shard) so that (a) a restored worker resumes exactly where the
checkpoint left off and (b) elastic membership changes redistribute shards
without duplicating or dropping data. State is a tiny dict stored in every
checkpoint's metadata.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SyntheticTokenSource:
    """Zipf-ish synthetic LM tokens: deterministic per (seed, step, shard)."""
    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, shard: int, n_shards: int,
              batch_per_shard: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        # zipf-like marginal over the vocab, cheap to draw
        u = rng.random((batch_per_shard, self.seq_len + 1))
        toks = ((self.vocab_size ** u - 1.0)
                / (self.vocab_size - 1.0) * (self.vocab_size - 1)).astype(
            np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class CIFARLikeSource:
    """32x32x3 synthetic image classification stream (the paper's workload
    shape; CIFAR-10 itself is not bundled offline — training-speed
    measurements only need the shapes, §III-A)."""
    n_classes: int = 10
    seed: int = 0

    def batch(self, step: int, shard: int, n_shards: int,
              batch_per_shard: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 7, step, shard]))
        x = rng.normal(0.0, 1.0, (batch_per_shard, 32, 32, 3)).astype(
            np.float32)
        y = rng.integers(0, self.n_classes, batch_per_shard).astype(np.int32)
        return {"images": x, "labels": y}


@dataclasses.dataclass
class SyntheticAudioSource:
    """Frame-embedding stream for encoder (audio) archs: (features, labels)
    deterministic per (seed, step, shard). Stands in for precomputed
    HuBERT-style frontend frames."""
    frontend_dim: int
    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, shard: int, n_shards: int,
              batch_per_shard: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 13, step, shard]))
        return {
            "features": rng.normal(
                0, 1, (batch_per_shard, self.seq_len, self.frontend_dim)
            ).astype(np.float32),
            "labels": rng.integers(
                0, self.vocab_size, (batch_per_shard, self.seq_len)
            ).astype(np.int32),
        }


def source_for_config(cfg, seq_len: int, seed: int = 0):
    """Pick the synthetic source matching a ModelConfig's input modality."""
    if cfg.family == "audio":
        return SyntheticAudioSource(cfg.frontend_dim, cfg.vocab_size,
                                    seq_len, seed=seed)
    return SyntheticTokenSource(cfg.vocab_size, seq_len, seed=seed)


class ShardedLoader:
    """Iterator facade with explicit state: (step,). Elastic-safe: shard
    count/batch come per-call so membership changes take effect next step."""

    def __init__(self, source, global_batch: int, start_step: int = 0):
        self.source = source
        self.global_batch = global_batch
        self.step = start_step

    def state(self) -> Dict[str, int]:
        return {"step": self.step, "global_batch": self.global_batch}

    def next_global(self, n_shards: int = 1) -> Dict[str, np.ndarray]:
        """Materialize the full global batch (concatenated shards)."""
        per = self.global_batch // max(1, n_shards)
        shards = [self.source.batch(self.step, s, n_shards, per)
                  for s in range(n_shards)]
        self.step += 1
        return {k: np.concatenate([sh[k] for sh in shards])
                for k in shards[0]}
