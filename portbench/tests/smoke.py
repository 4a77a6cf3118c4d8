"""Fixtures of the benchmark's own tests, imported by each test module (CPU;
the ``cuda`` tests skip in a fixture where there is no card).

`smoke_root` is a copy of the benchmark in a temporary checkout with two
cells added the way a later change adds one, by new files and new entries:
each family at the port's SMOKE sizes (``preset: smoke``), on a short
traffic mix."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_CONFIGS = {
    "stablelm-smoke": {
        "base": "stablelm-1.6b",
        "keys": {"hidden_size": 128, "intermediate_size": 256,
                 "num_attention_heads": 4, "num_key_value_heads": 4,
                 "num_hidden_layers": 2, "vocab_size": 512},
        "program": {"n_layers": 2, "d_model": 128, "n_heads": 4,
                    "n_kv_heads": 4, "head_dim": 32, "d_ff": 256,
                    "vocab_size": 512}},
    "mamba2-smoke": {
        "base": "mamba2-1.3b",
        "keys": {"d_model": 128, "n_layer": 2, "vocab_size": 512,
                 "d_state": 16, "headdim": 32, "chunk_size": 32},
        "program": {"n_layers": 2, "d_model": 128, "vocab_size": 512,
                    "ssm": {"d_state": 16, "d_conv": 4, "expand": 2,
                            "head_dim": 32, "n_groups": 1, "chunk_size": 32,
                            "a_init_range": [1.0, 16.0]}}},
}
SMOKE_TRAFFIC = {"seq_len": 64, "global_batch": 4}
#: the SMOKE cells' limits, on the numbers of the full-width cells they
#: stand for, set by their rule from `calibrate.py --device cpu` at these
#: sizes (14 seeds; the fp8 control and half of the batch on 4): lower
#: (largest program reading) x (upper / lower)^0.6
SMOKE_LIMITS = {
    "stablelm-smoke.train": {     # lower 3.07e-3, 0.0194, 5.17e-3, 8.42e-4
        "grad_gap": 0.0074, "grad_err": 0.082, "moment_gap": 0.020,
        "change_gap": 0.0018},    # upper: fp8 0.0132, 0.215, 0.0481, 3.12e-3
    "mamba2-smoke.train": {       # lower 5.44e-3, 0.0170, 1.52e-3, 0.0126
        "grad_gap": 0.036, "grad_err": 0.072, "moment_gap_median": 0.0041,
        "change_gap": 0.066}}     # upper: half 0.129, fp8 0.187, 8.0e-3,
#                                   half 0.196


def add_smoke_cells(root: pathlib.Path) -> None:
    bench = root / "portbench"
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((bench / "traffic" / "train-2k-b4.json").read_text())
    traffic.update(SMOKE_TRAFFIC)
    (bench / "traffic" / "smoke.json").write_text(json.dumps(traffic))
    for name, spec in SMOKE_CONFIGS.items():
        base = next(c for c in manifest["configs"] if c["name"] == spec["base"])
        cfg = json.loads((root / base["file"]).read_text())
        cfg.update(spec["keys"], name=name)
        cfg["program"]["preset"] = "smoke"
        cfg["program"]["config"].update(spec["program"])
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        manifest["configs"].append(dict(base, name=name,
                                        file=f"portbench/configs/{name}.json"))
        cell = f"{name.split('-')[0]}-smoke.train"
        manifest["workloads"].append({"name": cell, "config": name,
                                      "traffic": "smoke", "chips": 1,
                                      "why": "the port's SMOKE sizes"})
        (bench / "checks" / f"{cell}.json").write_text(
            json.dumps({"limits": SMOKE_LIMITS[cell]}))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def smoke_root(tmp_path) -> pathlib.Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_smoke_cells(root)
    return root


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
