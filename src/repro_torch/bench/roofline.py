"""Roofline table from the dry-run artifacts (deliverable g).

Reads the port's sweep, artifacts/dryrun_torch/*.json (`python -m
repro_torch dryrun --sweep`, run from the repo root); emits per (arch x
shape x mesh): the three roofline terms (compute / memory / collective,
seconds), the dominant term, MODEL_FLOPS/HLO_FLOPS, and a one-line "what
would move the dominant term".

The port's twin of `benchmarks/roofline.py`.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.launch.sweep import DEFAULT_OUT_DIR

# under the repo root, which holds src/repro_torch/bench/
ART = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), DEFAULT_OUT_DIR)

_ADVICE = {
    "compute_s": "raise tensor-core utilization: larger per-card GEMM tiles "
                 "(less TP), the hand-written flash/SSD kernels on wgmma, "
                 "bf16 throughout",
    "memory_s": "cut HBM traffic: the flash kernels (no S^2 materialization), "
                "selective remat policy, fused elementwise passes, bf16 "
                "master-free optimizer",
    "collective_s": "reshape layout: lower TP degree / batch-shard the model "
                    "axis, overlap grad all-reduce with bwd, compress grads",
}


def load_records(pattern: str = "*.json") -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(ART, pattern))):
        try:
            recs = json.load(open(path))
        except json.JSONDecodeError:
            continue
        out.extend(recs if isinstance(recs, list) else [recs])
    return out


def fmt_row(r: dict) -> Optional[dict]:
    if r.get("skipped"):
        return {"arch": r["arch"], "shape": r["shape"], "mesh": "-",
                "skipped": True, "reason": r.get("reason", "")}
    if not r.get("ok"):
        return {"arch": r.get("arch"), "shape": r.get("shape"),
                "mesh": r.get("mesh"), "failed": True}
    terms = r["roofline"]
    dom = r["bottleneck"]
    total = max(sum(terms.values()), 1e-12)
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"], "bottleneck": dom,
        "roofline_fraction": terms["compute_s"] / max(terms.values()),
        "useful_flops_ratio": r.get("useful_flops_ratio", 0.0),
        "advice": _ADVICE[dom],
    }


def markdown_table(rows: List[dict]) -> str:
    lines = ["| arch | shape | mesh | compute s | memory s | collective s | "
             "bottleneck | MODEL/HLO flops | roofline frac |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r is None:
            continue
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                         f"skipped: {r['reason'][:40]} | — | — |")
            continue
        if r.get("failed"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                         f"| FAILED | | | | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | {r['bottleneck'].replace('_s','')} "
            f"| {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def run(mesh: Optional[str] = "16x16") -> List[dict]:
    """Default: single-pod only (the §Roofline table per spec); pass
    mesh=None for everything (the §Dry-run pass/fail listing)."""
    rows = [fmt_row(r) for r in load_records()]
    rows = [r for r in rows if r is not None]
    if mesh:
        rows = [r for r in rows
                if r.get("skipped") or r.get("mesh") == mesh]
    return rows


def dryrun_status() -> List[dict]:
    """Pass/fail per (arch, shape, mesh) — proves both meshes compile."""
    out = []
    for r in load_records():
        out.append({
            "arch": r.get("arch"), "shape": r.get("shape"),
            "mesh": r.get("mesh", "-"),
            "status": ("skipped" if r.get("skipped")
                       else "ok" if r.get("ok") else "FAILED"),
            "compile_s": r.get("compile_s"),
            "temp_gb": (r.get("memory", {}).get("temp_bytes", 0) or 0) / 1e9,
        })
    return out


def main():
    rows = run()
    print(markdown_table(rows))
    done = [r for r in rows if not r.get("skipped") and not r.get("failed")]
    if done:
        worst = min(done, key=lambda r: r["roofline_fraction"])
        coll = max(done, key=lambda r: r["collective_s"])
        print(f"\nworst roofline fraction: {worst['arch']} {worst['shape']} "
              f"{worst['mesh']} ({worst['roofline_fraction']:.3f})")
        print(f"most collective-bound: {coll['arch']} {coll['shape']} "
              f"{coll['mesh']} ({coll['collective_s']:.3f}s)")


if __name__ == "__main__":
    main()
