"""§VI-A use case: predict heterogeneous-cluster training speed and total
training time (Eq 4/5), then validate against the discrete-event fleet
simulator — the paper reports 0.8% error for ResNet-32.

PYTHONPATH=src python -m repro_torch.examples.heterogeneous_predict

The port's twin of `examples/heterogeneous_predict.py`: host only.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench._common import cnn_leaves
from repro_torch.core.perf_model.cluster_model import (Eq4Inputs,
                                                 HeterogeneousPredictor,
                                                 WorkerSpec, cluster_speed,
                                                 predict_total_time)
from repro_torch.core.perf_model.speed_model import (TABLE1_MODELS,
                                               WorkerSpeedPredictor,
                                               calibrate_generators,
                                               synth_dataset)
from repro_torch.core.transient.fleet import FleetSim, SimWorker
from repro_torch.core.transient.revocation import REGION_GPU_PARAMS
from repro_torch.models import cnn


def main():
    # 1. fit per-GPU SVR-RBF speed predictors on the measurement dataset
    models = {name: cnn.flops_per_image(spec) / 1e9
              for name, spec in cnn.ZOO.items()}
    rows = synth_dataset(models, samples_per=5, seed=0)
    preds = {g: WorkerSpeedPredictor.fit(rows, g)
             for g in ("k80", "p100", "v100")}
    c_m = TABLE1_MODELS["resnet_32"]
    print("predicted solo speeds for ResNet-32 (steps/s):",
          {g: round(p.speed(c_m), 2) for g, p in preds.items()})

    # 2. compose: sp = sum sp_i for a 2xK80 + 1xP100 + 1xV100 cluster
    counts = {"k80": 2, "p100": 1, "v100": 1}
    nt = cnn_leaves(cnn.RESNET_32)
    hp = HeterogeneousPredictor({g: p.speed(c_m) for g, p in preds.items()},
                                model_bytes=4.0 * cnn.param_count(cnn.RESNET_32),
                                n_ps=1, n_tensors=nt)
    sp = hp.predict(counts)
    print(f"predicted cluster speed: {sp:.2f} steps/s")

    # 3. Eq (4)/(5): total time for 64K steps, I_c=4K
    region = "us-central1"
    n_w, i_c, t_c = 64000, 4000, 3.84
    hours = n_w / sp / 3600
    probs = [REGION_GPU_PARAMS[(region, g)].prob_revoked_within(
        min(hours, 24.0)) for g, n in counts.items() for _ in range(n)]
    pred_t = predict_total_time(sp, Eq4Inputs(n_w, i_c, t_c, 75.0, 40.0, probs))
    print(f"Eq(4) predicted total time: {pred_t:.0f}s "
          f"(E[revocations]={sum(probs):.2f})")

    # 4. validate against the fleet simulator
    gens = calibrate_generators()
    workers = []
    wid = 0
    for g, n in counts.items():
        for _ in range(n):
            workers.append(SimWorker(wid, g, region,
                                     1.0 / gens[g].step_time(c_m)))
            wid += 1
    sims = [FleetSim(list(workers), model_gflops=c_m,
                     model_bytes=4.0 * cnn.param_count(cnn.RESNET_32),
                     step_speed_of=lambda g: 1.0 / gens[g].step_time(c_m),
                     checkpoint_interval_steps=i_c, checkpoint_time_s=t_c,
                     seed=s).run(n_w).total_time_s for s in range(4)]
    sim_t = float(np.mean(sims))
    print(f"simulated total time: {sim_t:.0f}s "
          f"-> prediction error {abs(pred_t-sim_t)/sim_t*100:.1f}% "
          f"(paper: 0.8%)")


if __name__ == "__main__":
    main()
