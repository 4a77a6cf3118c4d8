"""Online recalibration loop (paper §IV-C: monitor deployed clusters and
retrain the predictors from live measurements).

The `Recalibrator` sits beside the `Controller` in the training loop:

    controller.check ──deviation──▶ CusumDetector ──alarm──▶ refit
                                                      │
                              model_drift event       │  model_refit event
                                                      ▼
          profiler.history() ──fit──▶ ClusterSpeedEstimator ──▶ ModelStore
                                                      │
                        trainer.predicted_speed ◀─────┘ (new version)

Division of labour with the controller: the controller owns *mitigation*
(the cluster is wrong — add a PS, compress, replace the straggler); the
recalibrator owns *model drift* (the cluster is fine, the prediction is
stale). A mitigation resets the CUSUM statistic instead of feeding it —
refitting right after a mitigation would bake the degraded speed into the
model and mask the bottleneck the controller just fixed.

The port's copy of the JAX package's `calibration/recalibrator.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from .drift import CusumDetector
from .estimator import ClusterSpeedEstimator
from .store import ModelStore

MODEL_NAME = "cluster_speed"


@dataclasses.dataclass(frozen=True)
class RecalibrationConfig:
    """Knobs for the drift/refit loop (CLI: `--recalibrate`, `--drift-*`)."""
    drift_threshold: float = 0.15   # CUSUM alarm level
    drift_allowance: float = 0.05   # per-check slack before accumulating
    refit_window: int = 6           # profiler records the refit consumes
    min_history: int = 3            # need this many records to refit
    cooldown_checks: int = 1        # checks to skip right after a refit
    trace_path: Optional[str] = None  # optional recorded provider trace


class Recalibrator:
    """Consumes controller detections + profiler history; maintains the
    `cluster_speed` estimator in a `ModelStore` and a refit ledger."""

    def __init__(self, config: Optional[RecalibrationConfig] = None,
                 store: Optional[ModelStore] = None,
                 emit: Optional[Callable[[str, dict], None]] = None) -> None:
        self.config = config or RecalibrationConfig()
        self.store = store if store is not None else ModelStore()
        self._emit = emit
        self.detector = CusumDetector(allowance=self.config.drift_allowance,
                                      threshold=self.config.drift_threshold)
        self.drift_events: List[Dict] = []
        self.refits: List[Dict] = []
        self._cooldown = 0

    # --------------------------------------------------------------- wiring
    def bind(self, emit: Callable[[str, dict], None]) -> None:
        """Late-bind the event sink (the trainer's `_emit`)."""
        self._emit = emit

    def seed(self, predicted_speed: float) -> None:
        """Record the static prediction as version 1, so the first refit
        becomes version 2 and the audit trail starts at the baseline."""
        if MODEL_NAME not in self.store:
            self.store.register(
                MODEL_NAME,
                ClusterSpeedEstimator(speed=float(predicted_speed),
                                      source="static"),
                note="static")

    @property
    def version(self) -> int:
        return self.store.version(MODEL_NAME) if MODEL_NAME in self.store else 0

    # ----------------------------------------------------------------- loop
    def observe(self, step: int, deviation: Optional[float],
                profiler) -> Optional[float]:
        """Feed one controller check. Returns the refit predicted speed
        when drift was confirmed and a refit succeeded, else None."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if not self.detector.observe(deviation):
            return None

        drift = {"step": int(step), "deviation": float(deviation),
                 "model_version": self.version}
        self.drift_events.append(drift)
        self._fire("model_drift", drift)

        history = profiler.history()[-self.config.refit_window:]
        if len(history) < max(self.config.min_history, 2):
            return None
        try:
            est = ClusterSpeedEstimator.fit(history, source="refit")
        except ValueError:
            return None

        self.seed(est.speed)  # no-op if already seeded
        old = self.store.current(MODEL_NAME)
        version = (self.store.update(MODEL_NAME, est)
                   if self.store.snapshots(MODEL_NAME)[-1][1] != est.params_hash()
                   else self.store.version(MODEL_NAME))
        refit = {"step": int(step), "model_version": version,
                 "old_speed": float(getattr(old, "speed", est.speed)),
                 "new_speed": est.speed, "n_obs": est.n_obs}
        self.refits.append(refit)
        self._fire("model_refit", refit)
        self._cooldown = self.config.cooldown_checks
        return est.speed

    def notify_mitigation(self, step: int) -> None:
        """The controller changed the cluster; deviation accumulated
        against the pre-mitigation prediction is void."""
        self.detector.reset()
        self._cooldown = max(self._cooldown, self.config.cooldown_checks)

    # ---------------------------------------------------------------- traces
    def ingest_trace(self, path: Optional[str] = None) -> List[str]:
        """Refit lifetime laws from a recorded eviction trace; returns the
        store names written (`lifetime/trace/<region>/<gpu>`)."""
        from repro_torch.core.transient.revocation import LifetimeModel

        from .traces import lifetimes_from_trace, load_trace

        p = path or self.config.trace_path
        if not p:
            return []
        events = load_trace(p)
        cells = sorted({(e.region, e.gpu) for e in events
                        if e.kind == "eviction"},
                       key=lambda c: (c[0] or "", c[1] or ""))
        written = []
        for region, gpu in cells:
            lifetimes = lifetimes_from_trace(events, region=region, gpu=gpu)
            if lifetimes.size < 3:
                continue
            est = LifetimeModel.fit(region or "trace", gpu or "any", lifetimes)
            name = f"lifetime/trace/{region or 'any'}/{gpu or 'any'}"
            if name in self.store:
                self.store.update(name, est, note="trace-refit")
            else:
                self.store.register(name, est, note="trace")
            written.append(name)
        return written

    # --------------------------------------------------------------- helpers
    def _fire(self, kind: str, payload: dict) -> None:
        if self._emit is not None:
            self._emit(kind, payload)
