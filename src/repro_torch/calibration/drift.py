"""CUSUM drift detection over controller deviations (docs/calibration.md).

One `Controller.check` deviation above the 6.7 % threshold can be noise or
a transient; a *persistent* shift is what should trigger a refit. The
detector accumulates the excess deviation above an `allowance` per check
(the classic one-sided CUSUM statistic):

    s <- max(0, s + (deviation - allowance))

and alarms when `s` crosses `threshold`. Mitigations reset the statistic
— the §VI-B levers (compression / extra PS) change the cluster itself, so
deviation accumulated against the pre-mitigation prediction is void, and
a refit right after a mitigation would bake the degraded speed into the
model and mask the bottleneck the controller just fixed.

The port's copy of the JAX package's `calibration/drift.py`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class CusumDetector:
    """One-sided CUSUM on prediction deviation (fractional, signed:
    positive = measured slower than predicted)."""
    allowance: float = 0.05      # per-check slack before accumulating
    threshold: float = 0.15      # alarm level for the cumulative excess
    two_sided: bool = False      # also alarm on measured >> predicted

    def __post_init__(self) -> None:
        self.s_pos = 0.0
        self.s_neg = 0.0
        self.alarms: List[dict] = []

    def observe(self, deviation: Optional[float]) -> bool:
        """Feed one check's deviation; True when drift is confirmed.
        A confirming observation resets the statistic (the refit that
        follows re-baselines the model)."""
        if deviation is None:
            return False
        d = float(deviation)
        self.s_pos = max(0.0, self.s_pos + (d - self.allowance))
        self.s_neg = max(0.0, self.s_neg + (-d - self.allowance))
        fired = self.s_pos >= self.threshold or (
            self.two_sided and self.s_neg >= self.threshold)
        if fired:
            self.alarms.append({"deviation": d, "s_pos": self.s_pos,
                                "s_neg": self.s_neg})
            self.reset()
        return fired

    def reset(self) -> None:
        self.s_pos = 0.0
        self.s_neg = 0.0

    @property
    def statistic(self) -> float:
        return self.s_pos
