"""Fig 4 — cluster training speed vs #P100 workers for the four T2T models:
near-linear for ResNet-15; plateaus for ResNet-32 / Shake-Shake-small
(PS bottleneck); flat-low for Shake-Shake-Big (GPU-bound).

The port's twin of `benchmarks/fig4_cluster_scaling.py`.
"""
from __future__ import annotations

from repro_torch.bench._common import cnn_leaves
from repro_torch.core.perf_model.cluster_model import PSBottleneckModel, WorkerSpec, cluster_speed
from repro_torch.core.perf_model.speed_model import TABLE1_MODELS, calibrate_generators
from repro_torch.models import cnn

SPECS = {"resnet_15": cnn.RESNET_15, "resnet_32": cnn.RESNET_32,
         "shake_shake_small": cnn.SHAKE_SMALL, "shake_shake_big": cnn.SHAKE_BIG}


def run():
    gens = calibrate_generators()
    out = []
    for model, c_m in TABLE1_MODELS.items():
        solo = 1.0 / gens["p100"].step_time(c_m)
        spec = SPECS[model]
        mb = 4.0 * cnn.param_count(spec)
        nt = cnn_leaves(spec)
        ps = PSBottleneckModel(mb, n_ps=1, n_tensors=nt)
        for n in (1, 2, 4, 6, 8):
            sp = cluster_speed([WorkerSpec("p100", solo)] * n, ps)
            out.append({"name": f"fig4/{model}/p100x{n}",
                        "value": round(sp, 3),
                        "derived": f"linear={solo*n:.3f} "
                                   f"capped={sp < solo*n - 1e-9}"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
