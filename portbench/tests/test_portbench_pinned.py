"""The token cells train on what they trained on before feeds were named by
the references: the SMOKE token cells' checked batches, pinned to the bit
as the tree before that change gave them. The references' readings are
held against the port by `test_portbench_reference.py`.

The pinned digests were produced by copying this file into that tree's
``portbench/tests/`` and running, from the root of the tree,

    python3 -m portbench.tests.test_portbench_pinned

which prints `readings()` as JSON.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import tempfile

CELLS = ["stablelm-smoke.train", "mamba2-smoke.train"]
SEEDS = [5, 2**31 + 11]


def readings() -> dict:
    """Per cell and seed: the sha256 of each checked step's token and label
    bytes, as the cell's feed yields them."""
    from portbench import harness
    from portbench.kinds import train
    from portbench.tests.smoke import REPO, add_smoke_cells

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
        shutil.copytree(REPO / "portbench", root / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        add_smoke_cells(root)
        for name in CELLS:
            cell = harness.find_cell(name, root)
            dims = cell.reference().dims(cell.config)
            for seed in SEEDS:
                feed = train.feed_for(cell, dims, seed)
                batches = [feed.batch(step, 0, 1,
                                      cell.traffic["global_batch"])
                           for step in range(train.CHECKED_STEPS)]
                out[f"{name}/{seed}"] = {
                    "batches": [{k: hashlib.sha256(b[k].tobytes())
                                 .hexdigest()
                                 for k in ("tokens", "labels")}
                                for b in batches]}
    return out


PINNED = {
 "mamba2-smoke.train/2147483659": {
  "batches": [
   {
    "labels": "d266880fc2ad4194ac1e421073b214c8045bebd644a4cc4e5a740585b391a76f",
    "tokens": "be5fc9a829f95ac19eeedbca3387228c3c66e7dda68477de04ebdbc772ad7132"
   },
   {
    "labels": "81ee21e1ea7df227a3e4538daf525b52df9bcff1f740f4b103e14bb2c1d4ea1d",
    "tokens": "591dc1a92b5560bed87795b4dcfdd56430e4d4ed4bdffbc59618eb9c6514fb9e"
   }
  ]
 },
 "mamba2-smoke.train/5": {
  "batches": [
   {
    "labels": "4813eef6a6697b44fb1f546d263acf6e98813eed358476a1b27a7f7cfd596816",
    "tokens": "669c44342c1cc603ce25752069ff7aed80047cc07d883e516472025b8c784ce1"
   },
   {
    "labels": "c5a2b0d09516f9c7a22cd11148082ad10314edded101c9cd6e3e035292fd02d3",
    "tokens": "31c73836b483df70b78fc05d1f9650a4c328b5b162d0f9bec43a1c3559182225"
   }
  ]
 },
 "stablelm-smoke.train/2147483659": {
  "batches": [
   {
    "labels": "d266880fc2ad4194ac1e421073b214c8045bebd644a4cc4e5a740585b391a76f",
    "tokens": "be5fc9a829f95ac19eeedbca3387228c3c66e7dda68477de04ebdbc772ad7132"
   },
   {
    "labels": "81ee21e1ea7df227a3e4538daf525b52df9bcff1f740f4b103e14bb2c1d4ea1d",
    "tokens": "591dc1a92b5560bed87795b4dcfdd56430e4d4ed4bdffbc59618eb9c6514fb9e"
   }
  ]
 },
 "stablelm-smoke.train/5": {
  "batches": [
   {
    "labels": "4813eef6a6697b44fb1f546d263acf6e98813eed358476a1b27a7f7cfd596816",
    "tokens": "669c44342c1cc603ce25752069ff7aed80047cc07d883e516472025b8c784ce1"
   },
   {
    "labels": "c5a2b0d09516f9c7a22cd11148082ad10314edded101c9cd6e3e035292fd02d3",
    "tokens": "31c73836b483df70b78fc05d1f9650a4c328b5b162d0f9bec43a1c3559182225"
   }
  ]
 }
}


def test_token_cells_read_what_they_read_before():
    assert readings() == PINNED


if __name__ == "__main__":
    print(json.dumps(readings(), indent=1, sort_keys=True))
