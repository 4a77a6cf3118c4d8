"""§IV — fault-tolerance (checkpoint) overhead modeling.

Checkpoint time T_c is predicted from checkpoint file sizes. TF's (data,
index, meta) triple maps to our checkpointer's (array-shard bytes, manifest
bytes, pytree-structure bytes) — same roles: S_d dominates, S_m/S_i correlate
with tensor count. Four models as Table IV: univariate (S_c), multivariate
(S_d,S_m), PCA-2 (S_d,S_m,S_i), SVR-RBF (S_c).

The paper's key structural finding — training and checkpointing are
SEQUENTIAL, so T_total = T_train + ceil(N_w/I_c) * T_c — is used by
cluster_model.predict_total_time.

The port's copy of the JAX package's `core/perf_model/checkpoint_model.py`
(it imports nothing of it). The port's `Checkpointer.save` returns the
(S_d, S_m, S_i) of a save as `CheckpointSizes`.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.perf_model.regression import (LinearModel, PCA,
                                                    kfold_mae, mae, mape,
                                                    train_test_split)
from repro_torch.core.perf_model.svr import SVR, grid_search_svr


@dataclasses.dataclass
class CkptRow:
    model: str
    s_d: float   # data bytes (array shards)
    s_m: float   # meta bytes (pytree structure)
    s_i: float   # index bytes (manifest)
    t_c: float   # measured checkpoint seconds

    @property
    def s_c(self) -> float:
        return self.s_d + self.s_m + self.s_i


@dataclasses.dataclass
class CkptModelReport:
    name: str
    input_feature: str
    kfold_mae: float
    kfold_mae_std: float
    test_mae: float
    test_mape: float
    extra: dict = dataclasses.field(default_factory=dict)


class _PCALinear:
    def __init__(self, n=2):
        self.pca = PCA(n)
        self.lm = LinearModel()

    def fit(self, X, y):
        Z = self.pca.fit_transform(X)
        self.lm.fit(Z, y)
        return self

    def predict(self, X):
        return self.lm.predict(self.pca.transform(X))


def table4_models(rows: List[CkptRow], seed: int = 0) -> List[CkptModelReport]:
    s_c = np.array([r.s_c for r in rows]) / 1e6   # MB scale
    s_d = np.array([r.s_d for r in rows]) / 1e6
    s_m = np.array([r.s_m for r in rows]) / 1e6
    s_i = np.array([r.s_i for r in rows]) / 1e6
    t = np.array([r.t_c for r in rows])
    reports = []

    def eval_model(name, feat, X, fit_fn, extra=None):
        km, ks = kfold_mae(fit_fn, X, t, k=5, seed=seed)
        Xtr, ytr, Xte, yte = train_test_split(X, t, 0.2, seed)
        m = fit_fn(Xtr, ytr)
        pred = m.predict(Xte)
        reports.append(CkptModelReport(name, feat, km, ks, mae(yte, pred),
                                       mape(yte, pred), extra or {}))

    eval_model("univariate", "S_c", s_c[:, None],
               lambda X, y: LinearModel().fit(X, y))
    eval_model("multivariate", "S_d,S_m", np.stack([s_d, s_m], 1),
               lambda X, y: LinearModel().fit(X, y))
    eval_model("multivariate_pca2", "PCA(S_d,S_m,S_i)",
               np.stack([s_d, s_m, s_i], 1),
               lambda X, y: _PCALinear(2).fit(X, y))

    # min-max normalize S_c (same preprocessing as the §III speed models);
    # fixed gamma=1 keeps the RBF lengthscale on the normalized range
    lo, hi = float(s_c.min()), float(s_c.max())
    Xn = ((s_c - lo) / max(hi - lo, 1e-9))[:, None]
    _, info = grid_search_svr(Xn, t, "rbf", seed=seed)
    Xtr, ytr, Xte, yte = train_test_split(Xn, t, 0.2, seed)
    m = SVR(kernel="rbf", C=info["C"], epsilon=info["epsilon"],
            gamma=1.0).fit(Xtr, ytr)
    pred = m.predict(Xte)
    reports.append(CkptModelReport("svr_rbf", "S_c", info["kfold_mae"],
                                   info["kfold_mae_std"], mae(yte, pred),
                                   mape(yte, pred),
                                   {"C": info["C"],
                                    "epsilon": info["epsilon"]}))
    return reports


@dataclasses.dataclass
class CheckpointTimePredictor:
    """Deployable T_c predictor (linear on S_c — retrains instantly, the
    paper's recommendation for monitored clusters; §IV-C)."""
    lm: LinearModel

    @classmethod
    def fit(cls, rows: List[CkptRow]) -> "CheckpointTimePredictor":
        s_c = np.array([r.s_c for r in rows]) / 1e6
        t = np.array([r.t_c for r in rows])
        return cls(LinearModel().fit(s_c[:, None], t))

    def predict_seconds(self, total_bytes: float) -> float:
        return float(max(0.0, self.lm.predict(
            np.array([[total_bytes / 1e6]]))[0]))

    # Estimator protocol (repro_torch.calibration) ------------------------
    def predict(self, total_bytes: float) -> float:
        return self.predict_seconds(total_bytes)

    def update(self, rows: List[CkptRow]) -> "CheckpointTimePredictor":
        """Linear model on S_c: refit IS the online update (§IV-C)."""
        return type(self).fit(rows)

    def score(self, rows: List[CkptRow]) -> dict:
        from repro_torch.calibration.estimator import score_predictions
        return score_predictions(
            [r.t_c for r in rows],
            [self.predict_seconds(r.s_c) for r in rows])

    def params_hash(self) -> str:
        from repro_torch.calibration.estimator import params_hash
        return params_hash("checkpoint_time", self.lm.w, self.lm.b)
