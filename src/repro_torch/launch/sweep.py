"""Resumable (arch x shape) dry-run sweep of the port — `python -m
repro_torch dryrun --sweep`, the twin of the JAX package's
`launch/sweep.py`.

Fans the full matrix out as parallel *subprocesses*, one fresh
interpreter a cell running `python -m repro_torch.launch.dryrun`, so a
crash (or a runaway count) in one cell cannot take down the sweep.

The sweep is resumable by construction: each cell writes one artifact
`<out-dir>/<arch>__<shape>.json` and cells whose artifact already exists
are skipped, so re-running after an interruption only counts the
missing cells. Failures leave a `.json.err` tombstone (tail of the child's
output) next to the missing artifact; inapplicable (arch, shape) cells are
recorded as explicit skip artifacts so the matrix is always complete on
disk. The default artifact directory is ``artifacts/dryrun_torch``,
beside the reference's ``artifacts/dryrun``, whose every JSON the
reference's own tests read.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import List, Optional, Tuple

import repro_torch

#: default artifact root, relative to the working directory
DEFAULT_OUT_DIR = os.path.join("artifacts", "dryrun_torch")


def cells() -> List[Tuple[str, str, bool]]:
    """The full (arch, shape, applicable?) matrix."""
    from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, get_config,
                                     valid_cells)

    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        valid = {s.name for s in valid_cells(cfg)}
        for s in ALL_SHAPES:
            out.append((arch, s.name, s.name in valid))
    return out


def artifact_path(out_dir: str, arch: str, shape: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}.json")


def write_skip(out_dir: str, arch: str, shape: str) -> None:
    """Record an inapplicable cell so the on-disk matrix stays complete."""
    with open(artifact_path(out_dir, arch, shape), "w") as f:
        json.dump([{"arch": arch, "shape": shape, "ok": False,
                    "skipped": True,
                    "reason": "inapplicable cell (docs/DESIGN.md §4)"}], f)


def run_one(out_dir: str, arch: str, shape: str, mesh: str,
            timeout: int) -> Tuple[str, str, str]:
    """One cell in a child interpreter; returns (arch, shape, status)."""
    path = artifact_path(out_dir, arch, shape)
    if os.path.exists(path):
        return arch, shape, "cached"
    env = dict(os.environ)
    # make sure the child resolves the same `repro_torch` package as the
    # parent, whether the sweep was launched from a checkout or an install
    pkg_root = os.path.dirname(os.path.abspath(
        next(iter(repro_torch.__path__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", path]
    t0 = time.time()
    try:
        p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=timeout)
        status = "ok" if p.returncode == 0 else "FAIL"
        if p.returncode != 0:
            with open(path + ".err", "w") as f:
                f.write(p.stdout[-5000:] + "\n--stderr--\n"
                        + p.stderr[-10000:])
    except subprocess.TimeoutExpired:
        status = "TIMEOUT"
        with open(path + ".err", "w") as f:
            f.write("timeout\n")
    return arch, shape, f"{status} ({time.time() - t0:.0f}s)"


def sweep(out_dir: str = DEFAULT_OUT_DIR, jobs: int = 3,
          mesh: str = "both", timeout: int = 3000,
          progress=print) -> int:
    """Run the matrix; returns the number of cells that FAILED/TIMED OUT."""
    os.makedirs(out_dir, exist_ok=True)
    todo = cells()
    progress(f"{len(todo)} cells total -> {out_dir}")
    failures = 0
    with ThreadPoolExecutor(max_workers=jobs) as ex:
        futs = {}
        for arch, shape, valid in todo:
            if not valid:
                if not os.path.exists(artifact_path(out_dir, arch, shape)):
                    write_skip(out_dir, arch, shape)
                progress(f"SKIP {arch} {shape}")
                continue
            futs[ex.submit(run_one, out_dir, arch, shape, mesh,
                           timeout)] = (arch, shape)
        for fut in as_completed(futs):
            arch, shape, status = fut.result()
            if "FAIL" in status or "TIMEOUT" in status:
                failures += 1
            progress(f"{arch:24s} {shape:12s} {status}")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch dryrun --sweep",
        description="parallel (arch x shape) dry-run sweep, resumable")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--timeout", type=int, default=3000,
                    help="seconds per cell before a TIMEOUT tombstone")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help="artifact directory (existing artifacts are "
                         "skipped: re-run to resume)")
    args = ap.parse_args(argv)
    failures = sweep(out_dir=args.out_dir, jobs=args.jobs, mesh=args.mesh,
                     timeout=args.timeout,
                     progress=lambda m: print(m, flush=True))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
