"""`repro_torch.calibration` — the calibration layer of the port (the twin
of the JAX package's `calibration/`): the `Estimator` protocol, the
versioned `ModelStore`, CUSUM drift detection, the online refit loop
(`Recalibrator`), recorded-trace ingestion (`traces.py`) and
PROFET/Habitat-style transfer to unmeasured (gpu, region) cells.
"""
from .drift import CusumDetector
from .estimator import (ClusterSpeedEstimator, Estimator, params_hash,
                        score_predictions)
from .recalibrator import RecalibrationConfig, Recalibrator
from .store import ModelStore, Snapshot
from .traces import (TraceEvent, eviction_hazard_windows,
                     lifetimes_from_trace, load_trace, parse_trace,
                     price_hazard_windows)
from .transfer import (fit_p24_effects, holdout_p24_report,
                       transfer_lifetime_model, transfer_p24,
                       transfer_step_time_model)

__all__ = [
    "ClusterSpeedEstimator", "CusumDetector", "Estimator", "ModelStore",
    "RecalibrationConfig", "Recalibrator", "Snapshot", "TraceEvent",
    "eviction_hazard_windows", "fit_p24_effects", "holdout_p24_report",
    "lifetimes_from_trace", "load_trace", "params_hash", "parse_trace",
    "price_hazard_windows", "score_predictions", "transfer_lifetime_model",
    "transfer_p24", "transfer_step_time_model",
]
