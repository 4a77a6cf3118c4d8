"""Fig 3 — step time vs normalized computation ratio C_norm and normalized
model complexity C_m: the correlations that justify the §III regression
features (GPUs collapse onto one trend line under C_norm; separate lines
under C_m -> per-GPU models are worth building).

The port's twin of `benchmarks/fig3_correlation.py`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.perf_model.features import c_norm, minmax_apply, minmax_fit
from repro_torch.core.perf_model.speed_model import synth_dataset
from repro_torch.models import cnn


def run():
    models = {name: cnn.flops_per_image(spec) / 1e9
              for name, spec in cnn.ZOO.items()}
    rows = synth_dataset(models, samples_per=5, seed=0)
    c_m = np.array([r["c_m"] for r in rows])
    c_g = np.array([r["c_gpu"] for r in rows])
    t = np.array([r["step_time"] for r in rows])
    cn = minmax_apply(c_norm(c_m, c_g), *minmax_fit(c_norm(c_m, c_g)))

    out = []
    r_all = float(np.corrcoef(cn, t)[0, 1])
    out.append({"name": "fig3/corr_step_time_vs_Cnorm_all_gpus",
                "value": round(r_all, 4),
                "derived": "GPUs collapse onto one line (paper: strong +)"})
    for gpu in ("k80", "p100", "v100"):
        sel = np.array([r["gpu"] == gpu for r in rows])
        r_gpu = float(np.corrcoef(c_m[sel], t[sel])[0, 1])
        out.append({"name": f"fig3/corr_step_time_vs_Cm_{gpu}",
                    "value": round(r_gpu, 4),
                    "derived": "per-GPU trend line"})
    # the separation claim: same C_m, different GPUs -> different step time
    sep = float(np.mean(t[c_g == 4.11]) / np.mean(t[c_g == 14.13]))
    out.append({"name": "fig3/k80_over_v100_step_time_ratio",
                "value": round(sep, 2),
                "derived": "distinct lines under C_m (>1 expected)"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
