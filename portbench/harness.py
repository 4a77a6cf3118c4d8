"""Everything the harness finds by name, from `BENCHMARK.json` at the root of
a checkout: a cell's configuration file (``configs/``), traffic mix
(``traffic/``), limits (``checks/``), the reference its configuration names
(``reference/``), the run of its traffic's kind (``kinds/``) and the reader
of each metric it reports (``metrics/<name>.py``, a ``read(run)`` that
returns a number, or None where it finds nothing to read). A cell, a
configuration, a mix or a metric is added by adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_DIR = "portbench"


@dataclasses.dataclass
class Cell:
    root: pathlib.Path
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def file(self, *parts: str) -> pathlib.Path:
        return self.root.joinpath(BENCH_DIR, *parts)

    def reference(self) -> ModuleType:
        return load(self.file("reference", self.config["reference"] + ".py"))

    def kind(self) -> ModuleType:
        return load(self.file("kinds", self.traffic["kind"] + ".py"))

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def load(path: pathlib.Path) -> ModuleType:
    """A module of the benchmark from its file (once a process)."""
    name = "portbench_file_" + "_".join(
        p.replace(".", "_").replace("-", "_") for p in path.parts[-2:])
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(workload: str, root: Optional[pathlib.Path] = None) -> Cell:
    root = pathlib.Path(root or ROOT)
    manifest = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    bench = root / BENCH_DIR
    return Cell(
        root=root, name=workload, chips=w["chips"], config=config,
        traffic=_read_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(bench / "checks" / f"{workload}.json")["limits"],
        end_to_end=[m for m in manifest["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, workload)])


def read_metrics(cell: Cell, run, trace: bool) -> dict:
    """Each metric of the cell that its reader finds, with its unit."""
    out = {}
    for m in cell.metrics(trace):
        value = load(cell.file("metrics", m["name"] + ".py")).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
