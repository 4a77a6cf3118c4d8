"""`BENCHMARK.json` and every file it names, found by name; the shape of
the manifest; and a cell, a configuration, a mix and a metric added
by new files and entries alone."""
from __future__ import annotations

import hashlib
import json
import pathlib
import re
import time

import pytest

from portbench.tests.smoke import QUEUED, smoke_root  # noqa: F401
from portbench import harness

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in MANIFEST["end_to_end"]} == {
        "train_tokens_per_s", "peak_mem_gb", "setup_s"}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    names = [x["name"] for x in metrics + MANIFEST["configs"]
             + MANIFEST["workloads"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)


@pytest.mark.parametrize("workload", CELLS + [QUEUED["workload"]["name"]])
def test_every_file_of_a_cell_is_found_by_name(workload, smoke_root):
    """Each cell's files; the queued cell's by its entries alone."""
    cell = harness.find_cell(workload, smoke_root)
    assert cell.kind().run and cell.reference().loss_sum
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load(cell.file("metrics",
                                               m["name"] + ".py")).read)
    config = next(c for c in MANIFEST["configs"] + [QUEUED["config"]]
                  if c["name"] == cell.config["name"])
    assert cell.config["reduced"] == config["reduced"]
    assert cell.config["source"] == config["source"]
    assert cell.limits and set(cell.limits) <= {
        "loss_gap", "grad_gap", "grad_err", "moment_gap",
        "moment_gap_median", "change_gap"}


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]
                                    + [QUEUED["config"]]])
def test_configuration_is_the_ports_at_full_width(config):
    """The file's statement of the program's configuration is the port's,
    and the reference's weights are the port's tree, name for name and
    shape for shape (on the meta device: nothing is allocated)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.tree import flatten
    from portbench.kinds.train import _check_program_config
    from portbench import weights
    entry = next(c for c in MANIFEST["configs"] + [QUEUED["config"]]
                 if c["name"] == config)
    cfg_file = json.loads((harness.ROOT / entry["file"]).read_text())
    cfg = get_config(cfg_file["program"]["arch"], smoke=False)
    _check_program_config(cfg, cfg_file["program"]["config"])
    ref = harness.load(harness.ROOT / "portbench" / "reference"
                       / (cfg_file["reference"] + ".py"))
    weights.check_names(ref.param_specs(ref.dims(cfg_file)), {
        n: tuple(t.shape) for n, t in flatten(api.param_shapes(cfg))})


def _digests(root: pathlib.Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_config_mix_and_metric_come_by_new_files(smoke_root):
    """The smoke cells (a configuration, a mix, limits and entries of
    their own) and a new metric run with no file of the benchmark edited
    but the manifest."""
    before = _digests(harness.ROOT / "portbench")
    after = _digests(smoke_root / "portbench")
    changed = {p for p in before if after.get(p) != before[p]}
    assert not changed
    assert len(after) > len(before)
    (smoke_root / "portbench" / "metrics" / "steps_traced.py").write_text(
        "def read(run):\n"
        "    return run.trace.steps if run.trace else None\n")
    manifest = json.loads((smoke_root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append(dict(manifest["per_layer"][0],
                                      name="steps_traced", unit="steps"))
    (smoke_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.find_cell("mamba2-smoke.train", smoke_root)
    # a long window: the traced steps stop at `TRACE_STEPS`
    result = cell.kind().run(cell, seed=4, seconds=600.0, trace=True,
                             device="cpu", started=time.perf_counter())
    assert result["metrics"]["steps_traced"]["value"] == \
        cell.kind().TRACE_STEPS


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no-such-cell")
