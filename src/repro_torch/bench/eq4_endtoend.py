"""§VI-A / Eq (4)(5) — end-to-end training-time prediction vs simulation.

Predict T for ResNet-32, N_w = 64K steps, I_c = 4K, on transient clusters
(homogeneous and heterogeneous), then run the discrete-event fleet simulator
with the same inputs and report the prediction error (paper: 0.8%).

The port's twin of `benchmarks/eq4_endtoend.py`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.perf_model.checkpoint_model import CheckpointTimePredictor
from repro_torch.core.perf_model.cluster_model import (Eq4Inputs, WorkerSpec,
                                                 cluster_speed,
                                                 expected_revocations,
                                                 predict_total_time)
from repro_torch.core.perf_model.speed_model import TABLE1_MODELS, calibrate_generators
from repro_torch.core.transient.fleet import FleetSim, SimWorker
from repro_torch.core.transient.replacement import ReplacementModel
from repro_torch.core.transient.revocation import REGION_GPU_PARAMS
from repro_torch.core.transient.startup import StartupModel
from repro_torch.models import cnn

N_W = 64_000
I_C = 4_000
T_C = 3.84            # paper's measured ResNet-32 checkpoint seconds
REGION = "us-central1"


def scenario(counts, seed=0):
    gens = calibrate_generators()
    c_m = TABLE1_MODELS["resnet_32"]
    mb = 4.0 * cnn.param_count(cnn.RESNET_32)
    workers, specs = [], []
    wid = 0
    for gpu, n in counts.items():
        sp = 1.0 / gens[gpu].step_time(c_m)
        for _ in range(n):
            workers.append(SimWorker(wid, gpu, REGION, sp))
            specs.append(WorkerSpec(gpu, sp))
            wid += 1
    sp_cluster = cluster_speed(specs)  # PS below saturation for these sizes
    # Eq 4/5 inputs
    run_hours_guess = N_W / sp_cluster / 3600.0
    probs = [REGION_GPU_PARAMS[(REGION, w.gpu)].prob_revoked_within(
        min(run_hours_guess, 24.0)) for w in workers]
    startup = StartupModel(seed)
    repl = ReplacementModel(seed)
    t_p = float(np.mean([startup.mean_total(w.gpu) for w in workers]))
    t_s = repl.cold_start_s(c_m)
    pred = predict_total_time(sp_cluster, Eq4Inputs(
        N_W, I_C, T_C, t_p, t_s, probs))
    # simulate
    sims = []
    for s in range(4):
        sim = FleetSim(
            [SimWorker(w.wid, w.gpu, w.region, w.speed) for w in workers],
            model_gflops=c_m, model_bytes=mb,
            step_speed_of=lambda g: 1.0 / gens[g].step_time(c_m),
            checkpoint_interval_steps=I_C, checkpoint_time_s=T_C,
            seed=seed + s)
        sims.append(sim.run(N_W).total_time_s)
    sim_mean = float(np.mean(sims))
    err = abs(pred - sim_mean) / sim_mean * 100
    return pred, sim_mean, err, expected_revocations(probs)


def run():
    out = []
    for name, counts in [("k80x4", {"k80": 4}),
                         ("hetero_2k80_1p100_1v100",
                          {"k80": 2, "p100": 1, "v100": 1})]:
        pred, sim, err, n_r = scenario(counts)
        out.append({"name": f"eq4/{name}",
                    "value": round(err, 2),
                    "derived": f"pred={pred:.0f}s sim={sim:.0f}s "
                               f"E[revocations]={n_r:.2f} (err %)"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
