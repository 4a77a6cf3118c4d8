"""Benchmark driver — one module per paper table/figure (+ the roofline).
Prints ``name,value,derived`` CSV rows.

    python -m repro_torch bench [--only table2_speed_models,...] [--list]
        [--device cpu]
    python -m repro_torch.bench.run --only table1_speed,fig2_stability

The port's twin of `benchmarks/run.py`, without `mc_speed` (the reference's
perf-trajectory benchmark with its baseline and regression gate, which
stays the reference's). The modules in ON_DEVICE run on the card unless
``--device`` names another device; the rest are host NumPy, as their
references are, and take no device. Exit status: 0 when every selected
module runs, 1 when any raises (its traceback goes to stderr), 2 for an
unknown ``--only`` name; a selection that needs the card raises
`NoCudaDevice` before any module runs when there is none.
"""
from __future__ import annotations

import importlib
import sys
import time
import traceback
from typing import List, Optional

from repro_torch.device import resolve_device
from repro_torch.launch.cli import make_parser

MODULES = [
    "table1_speed",
    "fig2_stability",
    "fig3_correlation",
    "table2_speed_models",
    "table3_worker_speed",
    "fig4_cluster_scaling",
    "fig5_checkpoint",
    "table4_ckpt_models",
    "fig6_startup",
    "table5_revocations",
    "fig10_replacement",
    "fig11_recomputation",
    "eq4_endtoend",
    "fig12_bottleneck",
    "cost_savings",
    "scheduler_gains",
    "cross_provider",
    "lm_speed_models",
    "chaos",
    "recalib",
    "serving",
    "roofline",
]

# the modules that run a model, and so take ``device``
ON_DEVICE = frozenset({"fig2_stability", "fig5_checkpoint",
                       "fig10_replacement", "lm_speed_models", "chaos",
                       "recalib", "serving"})


def _run_module(name: str, device) -> List[dict]:
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    if name == "roofline":
        return [{"name": f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
                 "value": round(r.get("roofline_fraction", 0.0), 4),
                 "derived": (f"bottleneck={r.get('bottleneck')} "
                             f"compute={r.get('compute_s', 0):.4f}s")}
                for r in mod.run()
                if not r.get("skipped") and not r.get("failed")]
    if name in ON_DEVICE:
        return mod.run(device=device)
    return mod.run()


def main(argv: Optional[List[str]] = None) -> int:
    ap = make_parser("repro_torch.bench.run",
                     "paper table/figure benchmark driver")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of benchmark modules")
    ap.add_argument("--list", action="store_true",
                    help="list module names and exit")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(MODULES))
        return 0
    only = [m for m in args.only.split(",") if m] if args.only else None
    unknown = sorted(set(only or []) - set(MODULES))
    if unknown:
        print(f"unknown benchmark module(s): {', '.join(unknown)}",
              file=sys.stderr)
        return 2
    selected = [m for m in MODULES if only is None or m in only]
    device = (resolve_device(args.device)
              if ON_DEVICE.intersection(selected) else None)

    print("name,value,derived")
    failed: List[str] = []
    for name in selected:
        t0 = time.time()
        try:
            rows = _run_module(name, device)
            for r in rows:
                derived = str(r.get("derived", "")).replace(",", ";")
                print(f"{r['name']},{r['value']},{derived}", flush=True)
            print(f"# {name} done in {time.time()-t0:.1f}s", flush=True)
        except Exception:
            failed.append(name)
            print(f"# {name} FAILED", flush=True)
            traceback.print_exc(file=sys.stderr)
    if failed:
        print(f"# {len(failed)}/{len(selected)} benchmark module(s) failed: "
              f"{', '.join(failed)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
