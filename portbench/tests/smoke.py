"""Fixtures of the benchmark's own tests, imported by each test module (CPU;
the ``cuda`` tests skip in a fixture where there is no card).

`smoke_root` is a copy of the benchmark in a temporary checkout with cells
added the way a later change adds one, by new files and new entries: each
family at the port's SMOKE sizes (``preset: smoke``), on a short traffic
mix, and the queued full-width cell whose files the benchmark already holds
(`QUEUED`), by its entries alone."""
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
    "hubert-smoke": {
        "base": "hubert-xlarge",
        "keys": {"hidden_size": 128, "intermediate_size": 256,
                 "num_attention_heads": 4, "num_hidden_layers": 2,
                 "conv_dim": [64] * 7, "num_codebook_units": 64},
        "program": {"n_layers": 2, "d_model": 128, "n_heads": 4,
                    "n_kv_heads": 4, "head_dim": 32, "d_ff": 256,
                    "vocab_size": 64, "frontend_dim": 64}},
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
        "change_gap": 0.066},     # upper: half 0.129, fp8 0.187, 8.0e-3,
#                                   half 0.196
    "hubert-smoke.train": {       # lower 1.17e-3, 0.0102, 2.54e-3, 8.0e-4
        "grad_gap": 0.0025, "grad_err": 0.053, "moment_gap": 0.0066,
        "change_gap": 0.0017}}    # upper: fp8 4.05e-3, 0.158, 0.0124,
#                                   2.84e-3


#: hubert's cell, whose configuration, reference, mix and limits are in the
#: benchmark but not in `BENCHMARK.json`: its throughput spreads 0.75-0.85%
#: run to run, with the program's copy of its input (PERF.md §7)
QUEUED = {
    "config": {
        "name": "hubert-xlarge",
        "source": "https://huggingface.co/facebook/hubert-xlarge-ll60k",
        "file": "portbench/configs/hubert-xlarge.json", "reduced": [],
        "why": "bidirectional encoder on frames, 16 heads of 80, GELU MLP: "
               "the flash forward and backward at hd 80 with every pair "
               "kept, RMSNorm, AdamW"},
    "workload": {
        "name": "hubert-xlarge.train-2k", "config": "hubert-xlarge",
        "traffic": "frames-2k-b14", "chips": 1,
        "why": "encoder pretraining on 2,048 frames, 14 rows a step, closed "
               "loop: the hd-80 bidirectional flash kernels beside cuBLAS "
               "and AdamW"},
    "per_layer": ["flash_fwd_roofline_pct", "flash_bwd_roofline_pct"]}


def add_queued_cell(root: pathlib.Path) -> None:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append(QUEUED["config"])
    manifest["workloads"].append(QUEUED["workload"])
    for m in manifest["per_layer"]:
        if m["name"] in QUEUED["per_layer"]:
            m["workloads"].append(QUEUED["workload"]["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


def add_smoke_cells(root: pathlib.Path) -> None:
    bench = root / "portbench"
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((bench / "traffic" / "train-2k-b4.json").read_text())
    traffic.update(SMOKE_TRAFFIC)
    (bench / "traffic" / "smoke.json").write_text(json.dumps(traffic))
    for name, spec in SMOKE_CONFIGS.items():
        cfg = json.loads((bench / "configs" / f"{spec['base']}.json")
                         .read_text())
        cfg.update(spec["keys"], name=name)
        cfg["program"]["preset"] = "smoke"
        cfg["program"]["config"].update(spec["program"])
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        manifest["configs"].append({
            "name": name, "source": cfg["source"],
            "file": f"portbench/configs/{name}.json",
            "reduced": cfg["reduced"], "why": "the port's SMOKE sizes"})
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
    add_queued_cell(root)
    return root


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
