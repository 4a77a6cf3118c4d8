"""§III — the calibrated GPU step-time generators: the port's copy of the
JAX package's `core/perf_model/speed_model.py`, cut to what the fleet
simulator and the calibration store need (`calibrate_generators`,
`GPUStepTimeModel` with its Estimator protocol methods).

A calibrated GPU step-time generator stands in for the paper's cloud fleet:
per-GPU piecewise-linear curves through Table I's published (C_m,
step-time) points. The Table II regression zoo (OLS, SVR),
`WorkerSpeedPredictor` and `synth_dataset` wait for ROADMAP.md queue 1
item 13.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

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
