"""The feeds: a batch is a pure function of (seed, step, shard), and the
reference draws the very batches the program trained on, every key of
them."""
from __future__ import annotations

import tempfile

import numpy as np
import pytest
import torch

from portbench.tests.smoke import smoke_root  # noqa: F401
from portbench import harness
from portbench.feed import FrameFeed

CELLS = ["stablelm-smoke.train", "mamba2-smoke.train", "hubert-smoke.train"]
SEED = 2**31 + 11


def _bytes(batch: dict) -> dict:
    return {k: (v.dtype.str, v.shape, v.tobytes()) for k, v in batch.items()}


def test_frame_feed_is_a_function_of_seed_step_and_shard():
    def feed(seed):
        return FrameFeed(width=16, vocab=504, seq_len=32, rows=8, seed=seed)

    a, b = feed(SEED), feed(SEED)
    for step, shard in [(0, 0), (1, 0), (7, 1)]:
        assert _bytes(a.batch(step, shard, 2, 4)) == \
            _bytes(b.batch(step, shard, 2, 4))
    one = a.batch(0, 0, 1, 4)
    assert one["features"].dtype == np.float32
    assert one["features"].shape == (4, 32, 16)
    assert one["labels"].dtype == np.int32 and one["labels"].shape == (4, 32)
    assert 0 <= one["labels"].min() and one["labels"].max() < 504
    others = [a.batch(1, 0, 1, 4), a.batch(0, 1, 2, 4),
              feed(SEED + 1).batch(0, 0, 1, 4)]
    for other in others:
        assert not np.array_equal(one["labels"], other["labels"])
    assert not np.array_equal(one["features"],
                              feed(SEED + 1).batch(0, 0, 1, 4)["features"])
    # the rows of a batch are rows of the bank, each once
    rows = {r.tobytes() for r in a.bank}
    assert len({r.tobytes() for r in one["features"]}) == 4
    assert {r.tobytes() for r in one["features"]} <= rows
    with pytest.raises(ValueError):
        a.batch(0, 0, 1, 9)


@pytest.mark.parametrize("workload", CELLS)
def test_the_reference_draws_the_batches_the_program_trained_on(
        smoke_root, workload):
    cell = harness.find_cell(workload, smoke_root)
    kind = cell.kind()
    dims = cell.reference().dims(cell.config)
    seen = []
    with tempfile.TemporaryDirectory() as ckpt:
        program = kind.Program(cell, SEED, "cpu", ckpt)
        step = program.trainer.train_step

        def recording(state, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(state, batch)

        program.trainer.train_step = recording
        program.checked_steps()
    drawn = kind.checked_batches(cell, dims, SEED, "cpu")
    assert len(seen) == len(drawn) == kind.CHECKED_STEPS
    for ours, theirs in zip(seen, drawn):
        assert set(ours) == set(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype
            assert torch.equal(ours[k], theirs[k]), k
