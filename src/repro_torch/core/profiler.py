"""CM-DARE performance profiler (Fig 1) — the part of the JAX package's
`core/profiler.py` that the trainer's loop uses: per-step records and the
steps/sec speed with warmup discard (§III-A/B). The windowed speeds and
their coefficient of variation feed the bottleneck controller and the
recalibrator, which are not ported yet (ROADMAP.md, queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class StepRecord:
    t: float
    step: int
    loss: Optional[float] = None


class PerformanceProfiler:
    """Mirrors the paper's measurement protocol: discard the first
    `warmup_steps` steps and `warmup_seconds` seconds."""

    def __init__(self, warmup_steps: int = 100, warmup_seconds: float = 30.0):
        self.warmup_steps = warmup_steps
        self.warmup_seconds = warmup_seconds
        self.records: List[StepRecord] = []

    def record(self, step: int, t: Optional[float] = None,
               loss: Optional[float] = None) -> None:
        self.records.append(
            StepRecord(time.monotonic() if t is None else t, step, loss))

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
