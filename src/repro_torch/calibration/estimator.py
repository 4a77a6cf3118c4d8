"""The `Estimator` protocol — one calibration contract for every model.

The prediction stack grew organically: §III step-time generators, the
Table II regression zoo, §IV checkpoint-time predictors, the Fig 4 PS
capacity law and the §V lifetime laws each had their own fit/predict
spelling. `docs/calibration.md` unifies them behind five methods so the
`ModelStore`, the `Recalibrator` and the transfer path can treat any of
them as "an estimator":

  fit(...)          (re)build the estimator from measurement rows
  predict(x)        point prediction for one input
  update(rows)      online refresh from new observations -> NEW estimator
                    (estimators are value objects; update never mutates)
  score(rows)       goodness-of-fit dict ({"mae", "mape", "n", ...})
  params_hash()     stable digest of the fitted parameters — equality of
                    hashes IS equality of calibrations, which is how the
                    golden-parity tests pin the unarmed path

Adopters: `GPUStepTimeModel` / `WorkerSpeedPredictor` (§III),
`CheckpointTimePredictor` (§IV), `PSBottleneckModel` (Fig 4 capacity),
`LifetimeModel` and the provider `LifetimeLaw`s (§V), plus the online
`ClusterSpeedEstimator` below that the drift/refit loop fits from
profiler history.

The port's copy of the JAX package's `calibration/estimator.py`.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, Protocol, runtime_checkable

import numpy as np


def params_hash(*parts) -> str:
    """Stable sha1 digest of fitted parameters (floats, strings, arrays).

    Floats are hashed via their IEEE bytes at full precision, so two
    estimators hash equal iff their parameters are bit-identical — the
    property the unarmed-mode golden tests rely on.
    """
    h = hashlib.sha1()
    for p in parts:
        if p is None:
            h.update(b"\x00none")
        elif isinstance(p, str):
            h.update(b"\x01" + p.encode())
        elif isinstance(p, (int, np.integer)):
            h.update(b"\x02" + int(p).to_bytes(8, "little", signed=True))
        else:
            arr = np.ascontiguousarray(np.asarray(p, float))
            h.update(b"\x03" + arr.tobytes())
    return h.hexdigest()


@runtime_checkable
class Estimator(Protocol):
    """Structural protocol — adopters need the methods, not a base class."""

    def predict(self, x): ...

    def update(self, rows) -> "Estimator": ...

    def score(self, rows) -> Dict[str, float]: ...

    def params_hash(self) -> str: ...


def score_predictions(y_true, y_pred) -> Dict[str, float]:
    """The shared `score()` body: MAE/MAPE over paired observations,
    with the empty-input guard every adopter needs (an estimator scored
    against nothing is a caller bug, not a 0.0)."""
    y_true = np.asarray(y_true, float)
    y_pred = np.asarray(y_pred, float)
    if y_true.size == 0:
        raise ValueError("score: no observations to score against")
    err = np.abs(y_true - y_pred)
    denom = np.maximum(np.abs(y_true), 1e-12)
    return {"n": int(y_true.size),
            "mae": float(err.mean()),
            "mape": float((err / denom).mean()) * 100.0}


@dataclasses.dataclass(frozen=True)
class ClusterSpeedEstimator:
    """Online cluster-speed estimator the `Recalibrator` refits from
    profiler history (docs/calibration.md §drift).

    The "model" is the paper's measured quantity itself — steps/s over a
    record window — which is exactly what `Controller.check` compares
    the live measurement against. `fit` consumes profiler records
    (dicts with `t`/`step`, the `PerformanceProfiler.history()` export).
    """
    speed: float
    n_obs: int = 0
    source: str = "static"       # static | refit | transfer

    @classmethod
    def fit(cls, records: Iterable[Dict[str, float]],
            source: str = "refit") -> "ClusterSpeedEstimator":
        rs = list(records)
        if len(rs) < 2:
            raise ValueError("ClusterSpeedEstimator.fit: need >= 2 records")
        span = rs[-1]["t"] - rs[0]["t"]
        if span <= 0:
            raise ValueError("ClusterSpeedEstimator.fit: zero time span")
        sp = (rs[-1]["step"] - rs[0]["step"]) / span
        return cls(speed=float(sp), n_obs=len(rs), source=source)

    def predict(self, x=None) -> float:
        return self.speed

    def update(self, records) -> "ClusterSpeedEstimator":
        return type(self).fit(records, source="refit")

    def score(self, records) -> Dict[str, float]:
        rs = list(records)
        speeds = []
        for a, b in zip(rs, rs[1:]):
            dt = b["t"] - a["t"]
            if dt > 0:
                speeds.append((b["step"] - a["step"]) / dt)
        return score_predictions(speeds, [self.speed] * len(speeds))

    def params_hash(self) -> str:
        return params_hash("cluster_speed", self.speed, self.n_obs,
                           self.source)
