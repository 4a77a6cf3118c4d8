"""Table IV — four checkpoint-time prediction models (univariate S_c,
multivariate (S_d,S_m), PCA-2, SVR-RBF) fitted on the measured Fig-5 data.
The trees are drawn and saved on the host, as the reference's are: this
table needs no device (Fig 5 itself runs on the card).

The port's twin of `benchmarks/table4_ckpt_models.py`.
"""
from __future__ import annotations

from repro_torch.bench.fig5_checkpoint import measure
from repro_torch.core.perf_model.checkpoint_model import table4_models


def run():
    rows = measure(repeats=3, device="cpu")
    reports = table4_models(rows)
    out = []
    for rep in reports:
        out.append({"name": f"table4/{rep.name}",
                    "value": round(rep.test_mae, 4),
                    "derived": (f"kfold={rep.kfold_mae:.4f}"
                                f"±{rep.kfold_mae_std:.4f} "
                                f"mape={rep.test_mape:.2f}% "
                                f"feat={rep.input_feature}")})
    svr = next(r for r in reports if r.name == "svr_rbf")
    others = [r.kfold_mae for r in reports if r.name != "svr_rbf"]
    out.append({"name": "table4/svr_best_kfold",
                "value": int(svr.kfold_mae <= min(others) + 1e-9),
                "derived": f"svr={svr.kfold_mae:.4f} "
                           f"others_min={min(others):.4f}"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
