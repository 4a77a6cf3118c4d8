"""`repro_torch.calibration` — the calibration layer of the port (the twin
of the JAX package's `calibration/`): the `Estimator` protocol, the
versioned `ModelStore`, CUSUM drift detection, the online refit loop
(`Recalibrator`) and PROFET/Habitat-style transfer to unmeasured (gpu,
region) cells. Recorded-trace ingestion (`traces.py`) waits for ROADMAP.md
queue 1 item 13.
"""
from .drift import CusumDetector
from .estimator import (ClusterSpeedEstimator, Estimator, params_hash,
                        score_predictions)
from .recalibrator import RecalibrationConfig, Recalibrator
from .store import ModelStore, Snapshot
from .transfer import (fit_p24_effects, holdout_p24_report,
                       transfer_lifetime_model, transfer_p24,
                       transfer_step_time_model)

__all__ = [
    "ClusterSpeedEstimator", "CusumDetector", "Estimator", "ModelStore",
    "RecalibrationConfig", "Recalibrator", "Snapshot", "fit_p24_effects",
    "holdout_p24_report", "params_hash", "score_predictions",
    "transfer_lifetime_model", "transfer_p24", "transfer_step_time_model",
]
