"""The paper's motivation quantified: monetary cost + wall-clock of training
on transient vs on-demand clusters (fleet simulation with GCP-2019-era
prices), including revocation/replacement overheads and checkpointing.

The port's twin of `benchmarks/cost_savings.py`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.perf_model.features import GPU_SPECS
from repro_torch.core.perf_model.speed_model import TABLE1_MODELS, calibrate_generators
from repro_torch.core.transient.fleet import FleetSim, SimWorker
from repro_torch.models import cnn

# 8x the paper's ResNet-32 run so the wall-clock (~8h on 4xK80) actually
# exposes revocations; checkpoint interval unchanged.
N_W = 512_000
I_C = 4_000
T_C = 3.84


def _run(gpu: str, n: int, transient: bool, seeds=(0, 1, 2)):
    gens = calibrate_generators()
    c_m = TABLE1_MODELS["resnet_32"]
    sp = 1.0 / gens[gpu].step_time(c_m)
    spec = GPU_SPECS[gpu]
    price = spec.transient_price if transient else spec.hourly_price
    times, costs, revs = [], [], []
    for s in seeds:
        workers = [SimWorker(i, gpu, "us-central1", sp) for i in range(n)]
        sim = FleetSim(workers, model_gflops=c_m,
                       model_bytes=4.0 * cnn.param_count(cnn.RESNET_32),
                       step_speed_of=lambda g: sp,
                       checkpoint_interval_steps=I_C, checkpoint_time_s=T_C,
                       seed=s, price_of={gpu: price})
        if not transient:
            sim.rev.rng = np.random.default_rng(10_000 + s)
            # on-demand: suppress revocations by monkey-setting lifetimes inf
            sim.rev.lifetime = lambda *a, **k: float("inf")
        res = sim.run(N_W)
        times.append(res.total_time_s)
        costs.append(res.monetary_cost)
        revs.append(res.revocations)
    return float(np.mean(times)), float(np.mean(costs)), float(np.mean(revs))


def run():
    out = []
    for gpu, n in (("k80", 4), ("v100", 4)):
        t_tr, c_tr, r_tr = _run(gpu, n, transient=True)
        t_od, c_od, _ = _run(gpu, n, transient=False)
        save = (1 - c_tr / c_od) * 100
        slow = (t_tr / t_od - 1) * 100
        out.append({"name": f"cost/{gpu}x{n}",
                    "value": round(save, 1),
                    "derived": (f"transient ${c_tr:.2f}/{t_tr/3600:.2f}h "
                                f"({r_tr:.1f} revocations) vs on-demand "
                                f"${c_od:.2f}/{t_od/3600:.2f}h; "
                                f"{slow:+.1f}% slower (cost savings %)")})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
