"""`repro_torch.calibration` — the calibration layer of the port (the twin
of the JAX package's `calibration/`): the `Estimator` protocol, the
versioned `ModelStore`, CUSUM drift detection and the online refit loop
(`Recalibrator`). Recorded-trace ingestion (`traces.py`) and the transfer
path (`transfer.py`) wait for ROADMAP.md queue 1 item 13.
"""
from .drift import CusumDetector
from .estimator import (ClusterSpeedEstimator, Estimator, params_hash,
                        score_predictions)
from .recalibrator import RecalibrationConfig, Recalibrator
from .store import ModelStore, Snapshot

__all__ = [
    "ClusterSpeedEstimator", "CusumDetector", "Estimator", "ModelStore",
    "RecalibrationConfig", "Recalibrator", "Snapshot", "params_hash",
    "score_predictions",
]
