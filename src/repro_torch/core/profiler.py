"""CM-DARE performance profiler (Fig 1): tracks steps/sec with warmup
discard, rolling averages, coefficient of variation — feeds the controller's
bottleneck detector and retrains the online prediction models.

The port's copy of the JAX package's `core/profiler.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class StepRecord:
    t: float
    step: int
    loss: Optional[float] = None


class PerformanceProfiler:
    """Mirrors the paper's measurement protocol: average speed every
    `window` steps, discard the first `warmup_steps` (§III-A/B)."""

    def __init__(self, window: int = 100, warmup_steps: int = 100,
                 warmup_seconds: float = 30.0):
        self.window = window
        self.warmup_steps = warmup_steps
        self.warmup_seconds = warmup_seconds
        self.records: List[StepRecord] = []
        self.window_speeds: List[float] = []
        self._win: Deque[StepRecord] = deque()

    def record(self, step: int, t: Optional[float] = None,
               loss: Optional[float] = None) -> None:
        rec = StepRecord(time.monotonic() if t is None else t, step, loss)
        self.records.append(rec)
        self._win.append(rec)
        if len(self._win) > self.window + 1:
            self._win.popleft()
        if len(self._win) >= self.window + 1:
            span = self._win[-1].t - self._win[0].t
            dsteps = self._win[-1].step - self._win[0].step
            if span > 0:
                self.window_speeds.append(dsteps / span)

    def _post_warmup(self) -> List[StepRecord]:
        if not self.records:
            return []
        t0 = self.records[0].t
        return [r for r in self.records
                if r.step >= self.warmup_steps
                and (r.t - t0) >= self.warmup_seconds]

    def speed(self) -> Optional[float]:
        """Current steps/s over post-warmup records."""
        rs = self._post_warmup()
        if len(rs) < 2:
            return None
        span = rs[-1].t - rs[0].t
        return (rs[-1].step - rs[0].step) / span if span > 0 else None

    def cov(self) -> Optional[float]:
        """Coefficient of variation of windowed speeds (Fig 2: <= 0.02)."""
        if len(self.window_speeds) < 2:
            return None
        arr = np.asarray(self.window_speeds, float)
        return float(arr.std() / max(arr.mean(), 1e-12))

    def step_time(self) -> Optional[float]:
        """Seconds per step; `None` only when there is genuinely no data.
        A measured speed of exactly 0.0 (a stalled run) is data — it maps
        to an infinite step time, not to "no measurement"."""
        sp = self.speed()
        if sp is None:
            return None
        return (1.0 / sp) if sp > 0 else float("inf")

    def history(self) -> List[dict]:
        """Export records as plain dicts — the calibration layer's refit
        input (`ClusterSpeedEstimator.fit`) and the Session's profiler
        history surface. Plain data, so consumers can serialize it."""
        return [{"t": r.t, "step": r.step, "loss": r.loss}
                for r in self.records]

    def recent_speed(self, last: int) -> Optional[float]:
        """Steps/s over the trailing `last` records only — what a refit
        wants after a regime change (the full-window `speed()` still
        averages across the shift)."""
        rs = self.records[-max(int(last), 2):]
        if len(rs) < 2:
            return None
        span = rs[-1].t - rs[0].t
        return (rs[-1].step - rs[0].step) / span if span > 0 else None
