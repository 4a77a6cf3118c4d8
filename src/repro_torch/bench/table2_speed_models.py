"""Table II — eight training-speed regression models (GPU-agnostic
univariate/multivariate OLS; per-GPU OLS and SVR poly/RBF) with k-fold and
test MAE, on the 20-CNN dataset (4 paper models + 16 custom variants).

The port's twin of `benchmarks/table2_speed_models.py`.
"""
from __future__ import annotations

from repro_torch.core.perf_model.speed_model import synth_dataset, table2_models
from repro_torch.models import cnn


def dataset(seed: int = 0):
    models = {name: cnn.flops_per_image(spec) / 1e9
              for name, spec in cnn.ZOO.items()}
    return synth_dataset(models, samples_per=5, seed=seed)


def run():
    rows = dataset()
    reports = table2_models(rows)
    out = []
    for rep in reports:
        out.append({
            "name": f"table2/{rep.name}",
            "value": round(rep.test_mae, 4),
            "derived": (f"kfold={rep.kfold_mae:.4f}±{rep.kfold_mae_std:.4f} "
                        f"test_mape={rep.test_mape:.2f}% "
                        f"feat={rep.input_feature}"),
        })
    # the paper's headline: per-GPU SVR-RBF beats GPU-agnostic models
    best_specific = min(r.test_mae for r in reports
                        if r.name.startswith("svr_rbf"))
    agnostic = [r.test_mae for r in reports if "agnostic" in r.name]
    out.append({"name": "table2/specific_beats_agnostic",
                "value": int(best_specific < min(agnostic)),
                "derived": f"svr_rbf={best_specific:.4f} "
                           f"vs agnostic_min={min(agnostic):.4f}"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
