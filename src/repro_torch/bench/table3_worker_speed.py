"""Table III — individual worker step time vs cluster size/heterogeneity
(ResNet-32): flat until the PS saturates; heterogeneity doesn't slow peers.
Reproduced with the async-PS queueing model (core/ps_async.py).

The port's twin of `benchmarks/table3_worker_speed.py`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench._common import cnn_leaves
from repro_torch.core.perf_model.speed_model import TABLE1_MODELS, calibrate_generators
from repro_torch.core.ps_async import ps_queue_sim
from repro_torch.models import cnn


def model_bytes() -> float:
    return 4.0 * cnn.param_count(cnn.RESNET_32)


def n_tensors() -> int:
    return cnn_leaves(cnn.RESNET_32)


def run():
    gens = calibrate_generators()
    c_m = TABLE1_MODELS["resnet_32"]
    t = {g: gens[g].step_time(c_m) for g in ("k80", "p100", "v100")}
    mb = model_bytes()
    nt = n_tensors()
    clusters = {
        "(1,0,0)": ["k80"], "(2,0,0)": ["k80"] * 2, "(4,0,0)": ["k80"] * 4,
        "(8,0,0)": ["k80"] * 8,
        "(0,4,0)": ["p100"] * 4, "(0,8,0)": ["p100"] * 8,
        "(0,0,4)": ["v100"] * 4, "(0,0,8)": ["v100"] * 8,
        "(2,1,1)": ["k80", "k80", "p100", "v100"],
    }
    out = []
    for name, gpus in clusters.items():
        res = ps_queue_sim([t[g] for g in gpus], mb, n_ps=1, steps=300,
                           n_tensors=nt)
        for gpu in sorted(set(gpus)):
            idx = gpus.index(gpu)
            eff_ms = res.worker_step_time[idx] * 1000
            solo_ms = t[gpu] * 1000
            out.append({"name": f"table3/{name}/{gpu}",
                        "value": round(eff_ms, 2),
                        "derived": f"solo={solo_ms:.2f}ms "
                                   f"slowdown={eff_ms/solo_ms:.3f} "
                                   f"ps_util={res.ps_utilization:.2f}"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
