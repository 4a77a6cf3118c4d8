"""A run of the harness end to end on the CPU at the SMOKE sizes (the look
for a card skipped), its result line, and the faults that must turn
``correct`` false."""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from portbench.tests.smoke import cuda, smoke_root  # noqa: F401
from portbench import harness

CELLS = ["stablelm-smoke.train", "mamba2-smoke.train", "hubert-smoke.train"]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, workload, trace=False, seed=2**31 + 11):
    cell = harness.find_cell(workload, root)
    return cell.kind().run(cell, seed=seed, seconds=0.5, trace=trace,
                           device="cpu", started=time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line_shape(smoke_root, workload, trace):
    result = _run(smoke_root, workload, trace)
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert dev["window_s"] > 0.0 and "busy_s" in dev
        # the CPU has no device trace: no device metric is read from it
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
        for m in result["metrics"].values():
            assert m["value"] > 0.0 and m["unit"]
    json.dumps(result)


def _unchanged(make):
    def make_step(cfg, run):
        step, opt = make(cfg, run)

        def train_step(state, batch):
            _, metrics = step(state, batch)
            return state, metrics   # the state handed back unchanged
        return train_step, opt
    return make_step


def _half_batch(make):
    def make_step(cfg, run):
        step, opt = make(cfg, run)

        def train_step(state, batch):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half)
        return train_step, opt
    return make_step


def _second_moment_decay(make):
    """AdamW's second moment decaying by b2 = 0.999 for the stated 0.95:
    for `moment_gap` (`moment_gap_median` in the mamba2 cell)."""
    def make_step(cfg, run):
        from repro_torch.optim import optimizers
        with mock.patch.object(optimizers, "adamw", functools.partial(
                optimizers.adamw, b2=0.999)):
            return make(cfg, run)
    return make_step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _second_moment_decay])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(smoke_root, workload, fault,
                                      monkeypatch):
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "make_train_step",
                        fault(steps.make_train_step))
    result = _run(smoke_root, workload)
    assert result["correct"] is False, result["checks"]


def _python(code, env=None, cwd=None):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=600)


def test_without_a_card_it_fails_and_prints_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(harness.ROOT / "portbench" / "run.py"),
         "--workload", "stablelm-1.6b.train-2k", "--seed", "5",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_program_refuses_to_fall_back_to_the_cpu(smoke_root):
    """A run on the card's path without a card raises; it never measures
    the CPU under the card's name."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell = harness.find_cell("stablelm-smoke.train", smoke_root)
    with pytest.raises(Exception):
        cell.kind().run(cell, seed=1, seconds=0.1, trace=False,
                        device="cuda", started=time.perf_counter())


def test_alone_in_a_directory_it_fails_and_prints_nothing(tmp_path):
    """With only BENCHMARK.json and portbench/ (no program beside them)."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mamba2-1.3b.train-2k", "--seed", "5", "--seconds", "1",
         "--trace", "1"], capture_output=True, text=True, cwd=tmp_path,
        timeout=600)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_loads_neither_jax_nor_the_jax_package(smoke_root):
    """The modules a run loads, compared by whole top-level name
    (`repro_torch` is not `repro`)."""
    code = f"""
import sys, time
sys.path[:0] = [{str(harness.ROOT)!r}, {str(harness.ROOT / 'src')!r}]
sys.argv = ["run.py"]
import importlib.util
spec = importlib.util.spec_from_file_location(
    "run", {str(harness.ROOT / 'portbench' / 'run.py')!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
from portbench import harness
cell = harness.find_cell("mamba2-smoke.train", {str(smoke_root)!r})
cell.kind().run(cell, seed=3, seconds=0.2, trace=True, device="cpu",
                started=time.perf_counter())
print(run.forbidden_modules(), "repro_torch" in sys.modules)
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_compared_whole(monkeypatch):
    sys.path.insert(0, str(harness.ROOT / "portbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()


@pytest.mark.cuda
def test_a_smoke_cell_on_the_card(smoke_root, cuda):
    cell = harness.find_cell("stablelm-smoke.train", smoke_root)
    result = cell.kind().run(cell, seed=9, seconds=0.5, trace=True,
                             device="cuda", started=time.perf_counter())
    assert result["correct"] and result["device"]["busy_s"] > 0.0
