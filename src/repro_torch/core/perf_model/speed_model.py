"""§III — training-speed characterization & prediction: the port's copy of
the JAX package's `core/perf_model/speed_model.py` (it imports nothing of
it).

* A calibrated GPU step-time generator stands in for the paper's cloud fleet
  (no K80/P100/V100 here): per-GPU piecewise-linear curves through Table
  I's published (C_m, step-time) points, and measurements drawn with the
  paper's observed stability (CoV <= 0.02, Fig 2).
* The full regression zoo of Table II is built on top: GPU-agnostic
  univariate (C_norm) / multivariate (C_m, C_gpu), per-GPU univariate OLS and
  SVR with polynomial / RBF kernels, with min-max normalization, k-fold CV
  and the 4:1 train/test protocol. The same pipeline fits rows measured on
  a real card (`chip_smoke.py` fits it to the H100's own step times).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.perf_model.features import (GPU_SPECS, c_norm,
                                                  minmax_apply, minmax_fit)
from repro_torch.core.perf_model.regression import (LinearModel, kfold_mae,
                                                    mae, mape,
                                                    train_test_split)
from repro_torch.core.perf_model.svr import SVR, grid_search_svr

# Table I of the paper: steps/s for (GPU x model); models with their GFLOPs.
TABLE1_MODELS = {  # name -> C_m in GFLOPs (paper's numbers, CIFAR-10)
    "resnet_15": 0.59,
    "resnet_32": 1.54,
    "shake_shake_small": 2.41,
    "shake_shake_big": 21.3,
}
TABLE1_SPEED = {  # gpu -> steps/s per model (paper Table I means)
    "k80": {"resnet_15": 9.46, "resnet_32": 4.56,
            "shake_shake_small": 2.58, "shake_shake_big": 0.70},
    "p100": {"resnet_15": 21.16, "resnet_32": 12.19,
             "shake_shake_small": 6.99, "shake_shake_big": 1.98},
    "v100": {"resnet_15": 27.38, "resnet_32": 15.61,
             "shake_shake_small": 8.80, "shake_shake_big": 2.18},
}
STEP_TIME_COV = 0.02  # Fig 2: post-warmup stability


@dataclasses.dataclass
class GPUStepTimeModel:
    """Calibrated per-GPU step-time generator: monotone piecewise-linear
    interpolation through Table I's (C_m, step-time) anchors (exact at the
    paper's published points; linear extrapolation outside)."""
    gpu: str
    c_anchors: np.ndarray      # GFLOPs, ascending
    t_anchors: np.ndarray      # seconds

    def step_time(self, c_m_gflops: float) -> float:
        c = float(c_m_gflops)
        ca, ta = self.c_anchors, self.t_anchors
        if c <= ca[0]:  # extrapolate with the first segment's slope
            slope = (ta[1] - ta[0]) / (ca[1] - ca[0])
            return max(1e-4, ta[0] + slope * (c - ca[0]))
        if c >= ca[-1]:
            slope = (ta[-1] - ta[-2]) / (ca[-1] - ca[-2])
            return max(1e-4, ta[-1] + slope * (c - ca[-1]))
        return float(np.interp(c, ca, ta))

    def sample(self, c_m_gflops: float, rng: np.random.Generator,
               n: int = 1) -> np.ndarray:
        t = self.step_time(c_m_gflops)
        return np.maximum(1e-4, rng.normal(t, STEP_TIME_COV * t, size=n))

    # Estimator protocol (repro_torch.calibration) ------------------------
    @classmethod
    def fit(cls, rows: List[dict], gpu: str) -> "GPUStepTimeModel":
        """Calibrate anchors from measurement rows ({c_m, step_time});
        repeated observations of one C_m average into one anchor."""
        sel = [r for r in rows if r.get("gpu", gpu) == gpu]
        if not sel:
            raise ValueError(f"GPUStepTimeModel.fit: no rows for {gpu!r}")
        by_c: Dict[float, List[float]] = {}
        for r in sel:
            by_c.setdefault(float(r["c_m"]), []).append(float(r["step_time"]))
        if len(by_c) < 2:
            raise ValueError("GPUStepTimeModel.fit: need >= 2 distinct C_m "
                             "anchors for interpolation")
        c = np.array(sorted(by_c))
        t = np.array([float(np.mean(by_c[ci])) for ci in c])
        return cls(gpu, c, t)

    def predict(self, c_m_gflops: float) -> float:
        return self.step_time(c_m_gflops)

    def update(self, rows: List[dict]) -> "GPUStepTimeModel":
        """Online refresh: rescale the anchor curve by the median observed
        /predicted step-time ratio (shape is Table I's; level is live)."""
        ratios = [float(r["step_time"]) / self.step_time(float(r["c_m"]))
                  for r in rows if r.get("gpu", self.gpu) == self.gpu]
        if not ratios:
            raise ValueError("GPUStepTimeModel.update: no rows for "
                             f"{self.gpu!r}")
        scale = float(np.median(ratios))
        return type(self)(self.gpu, self.c_anchors.copy(),
                          self.t_anchors * scale)

    def score(self, rows: List[dict]) -> Dict[str, float]:
        from repro_torch.calibration.estimator import score_predictions
        sel = [r for r in rows if r.get("gpu", self.gpu) == self.gpu]
        return score_predictions(
            [r["step_time"] for r in sel],
            [self.step_time(float(r["c_m"])) for r in sel])

    def params_hash(self) -> str:
        from repro_torch.calibration.estimator import params_hash
        return params_hash("step_time", self.gpu, self.c_anchors,
                           self.t_anchors)


_GENERATOR_CACHE: Optional[Dict[str, GPUStepTimeModel]] = None


def calibrate_generators() -> Dict[str, GPUStepTimeModel]:
    """Anchor each GPU's step-time curve at Table I's published points.

    Memoized at module level — the calibration is pure (Table I constants
    only) — so repeated calls share the same `GPUStepTimeModel` instances.
    Returns a fresh dict each time so callers may add/drop entries without
    aliasing."""
    global _GENERATOR_CACHE
    if _GENERATOR_CACHE is None:
        out = {}
        for gpu, speeds in TABLE1_SPEED.items():
            c = np.array([TABLE1_MODELS[m] for m in speeds])
            t = np.array([1.0 / s for s in speeds.values()])
            order = np.argsort(c)
            out[gpu] = GPUStepTimeModel(gpu, c[order], t[order])
        _GENERATOR_CACHE = out
    return dict(_GENERATOR_CACHE)


def synth_dataset(models: Dict[str, float],
                  gpus: Tuple[str, ...] = ("k80", "p100", "v100"),
                  samples_per: int = 5, seed: int = 0):
    """Generate the paper's measurement dataset: (C_m, C_gpu, step_time) for
    every (CNN x GPU), multiple observations each (averaged-100-step samples).

    models: name -> C_m (GFLOPs).
    """
    gens = calibrate_generators()
    rng = np.random.default_rng(seed)
    rows = []
    for gpu in gpus:
        for name, c_m in models.items():
            ts = gens[gpu].sample(c_m, rng, samples_per)
            for t in ts:
                rows.append({"model": name, "gpu": gpu, "c_m": c_m,
                             "c_gpu": GPU_SPECS[gpu].teraflops,
                             "step_time": float(t)})
    return rows


@dataclasses.dataclass
class SpeedModelReport:
    name: str
    input_feature: str
    kfold_mae: float
    kfold_mae_std: float
    test_mae: float
    test_mape: float
    extra: dict = dataclasses.field(default_factory=dict)


def table2_models(rows: List[dict], seed: int = 0) -> List[SpeedModelReport]:
    """Fit and evaluate the paper's eight Table-II regression models."""
    c_m = np.array([r["c_m"] for r in rows])
    c_gpu = np.array([r["c_gpu"] for r in rows])
    t = np.array([r["step_time"] for r in rows])
    cn = c_norm(c_m, c_gpu)
    lo_n, hi_n = minmax_fit(cn)
    lo_m, hi_m = minmax_fit(c_m)
    cn_n = minmax_apply(cn, lo_n, hi_n)
    cm_n = minmax_apply(c_m, lo_m, hi_m)
    cg_n = minmax_apply(c_gpu, *minmax_fit(c_gpu))
    reports = []

    def eval_model(name, feat_name, X, y, fit_fn, extra=None):
        km, ks = kfold_mae(fit_fn, X, y, k=5, seed=seed)
        Xtr, ytr, Xte, yte = train_test_split(X, y, 0.2, seed)
        m = fit_fn(Xtr, ytr)
        pred = m.predict(Xte)
        reports.append(SpeedModelReport(name, feat_name, km, ks,
                                        mae(yte, pred), mape(yte, pred),
                                        extra or {}))

    # GPU-agnostic
    eval_model("univariate_gpu_agnostic", "C_norm", cn_n[:, None], t,
               lambda X, y: LinearModel().fit(X, y))
    eval_model("multivariate_gpu_agnostic", "C_m,C_gpu",
               np.stack([cm_n, cg_n], 1), t,
               lambda X, y: LinearModel().fit(X, y))

    # per-GPU
    for gpu in sorted({r["gpu"] for r in rows}):
        sel = np.array([r["gpu"] == gpu for r in rows])
        Xg, yg = cm_n[sel][:, None], t[sel]
        eval_model(f"univariate_{gpu}", "C_m", Xg, yg,
                   lambda X, y: LinearModel().fit(X, y))
        for kern in ("poly", "rbf"):
            _, info = grid_search_svr(Xg, yg, kern, seed=seed)
            Xtr, ytr, Xte, yte = train_test_split(Xg, yg, 0.2, seed)
            m = SVR(kernel=kern, C=info["C"], epsilon=info["epsilon"]
                    ).fit(Xtr, ytr)
            pred = m.predict(Xte)
            reports.append(SpeedModelReport(
                f"svr_{kern}_{gpu}", "C_m", info["kfold_mae"],
                info["kfold_mae_std"], mae(yte, pred), mape(yte, pred),
                {"C": info["C"], "epsilon": info["epsilon"]}))
    return reports


@dataclasses.dataclass
class WorkerSpeedPredictor:
    """Deployable per-GPU predictor (the paper's best: per-GPU SVR-RBF),
    with the OLS fallback for fast retraining (§IV-C discussion)."""
    gpu: str
    svr: SVR
    lo: float
    hi: float

    @classmethod
    def fit(cls, rows: List[dict], gpu: str) -> "WorkerSpeedPredictor":
        sel = [r for r in rows if r["gpu"] == gpu]
        c_m = np.array([r["c_m"] for r in sel])
        t = np.array([r["step_time"] for r in sel])
        lo, hi = minmax_fit(c_m)
        m, _ = grid_search_svr(minmax_apply(c_m, lo, hi)[:, None], t, "rbf")
        return cls(gpu, m, lo, hi)

    def step_time(self, c_m: float) -> float:
        x = minmax_apply(np.array([c_m]), self.lo, self.hi)[:, None]
        return float(self.svr.predict(x)[0])

    def speed(self, c_m: float) -> float:
        return 1.0 / self.step_time(c_m)

    # Estimator protocol (repro_torch.calibration) ------------------------
    def predict(self, c_m: float) -> float:
        return self.step_time(c_m)

    def update(self, rows: List[dict]) -> "WorkerSpeedPredictor":
        """Full SVR refit from fresh rows (§IV-C: the SVR is cheap enough
        to retrain on a monitoring cadence)."""
        return type(self).fit(rows, self.gpu)

    def score(self, rows: List[dict]) -> Dict[str, float]:
        from repro_torch.calibration.estimator import score_predictions
        sel = [r for r in rows if r.get("gpu", self.gpu) == self.gpu]
        return score_predictions(
            [r["step_time"] for r in sel],
            [self.step_time(float(r["c_m"])) for r in sel])

    def params_hash(self) -> str:
        from repro_torch.calibration.estimator import params_hash
        return params_hash("worker_speed", self.gpu, self.lo, self.hi,
                           self.svr.kernel, self.svr.beta_, self.svr.b_,
                           self.svr.X_)
