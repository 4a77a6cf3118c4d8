"""Table I — training speed (steps/s) per (GPU x model), simplest cluster.

Validates the calibrated per-GPU step-time generator against the paper's
published means (the generator is the fleet stand-in; docs/DESIGN.md §2).

The port's twin of `benchmarks/table1_speed.py`.
"""
from __future__ import annotations

from repro_torch.core.perf_model.speed_model import (TABLE1_MODELS, TABLE1_SPEED,
                                               calibrate_generators)


def run():
    gens = calibrate_generators()
    rows = []
    for gpu, speeds in TABLE1_SPEED.items():
        for model, paper_speed in speeds.items():
            pred = 1.0 / gens[gpu].step_time(TABLE1_MODELS[model])
            err = abs(pred - paper_speed) / paper_speed * 100
            rows.append({"name": f"table1/{gpu}/{model}",
                         "value": round(pred, 3),
                         "derived": f"paper={paper_speed} err%={err:.2f}"})
    errs = [float(r["derived"].split("err%=")[1]) for r in rows]
    rows.append({"name": "table1/MAPE_vs_paper",
                 "value": round(sum(errs) / len(errs), 3), "derived": "%"})
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
