"""SLO-graceful degradation tiers for the serving fleet.

Mirrors the training-side `resilience.DegradationPolicy` (quorum tiers on
the alive fraction of the roster), but the levers are serving-shaped: cap
generation length, shrink the per-replica batch ceiling, and finally shed
non-priority traffic — stepping capacity down *before* the latency SLO is
violated rather than after. Effects are cumulative by severity: a fleet
degraded enough to shed low-priority traffic is also running the reduced
token cap and the shrunk batch ceiling.

Tier transitions are what the chaos evaluator scores: the simulator emits
one ``serving_degraded`` record per change, and a return to ``full``
after any degraded tier counts as a recovery cycle (the serve_wave gate).
The defaults (all thresholds 0) never degrade, so an unarmed fleet is
behavior-preserving — the same convention as `DegradationPolicy`.

The port's copy of the JAX package's `serving/degradation.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses

#: severity order, mildest first — `severity()` indexes into this
TIERS = ("full", "reduce_tokens", "shrink_batch", "shed_low_priority")


@dataclasses.dataclass(frozen=True)
class ServingDegradationPolicy:
    """Alive-fraction thresholds, most severe checked first:
    ``frac < shed_below`` → shed_low_priority; ``frac <
    shrink_batch_below`` → shrink_batch; ``frac < reduce_tokens_below``
    → reduce_tokens; else full."""
    reduce_tokens_below: float = 0.0
    shrink_batch_below: float = 0.0
    shed_below: float = 0.0
    token_factor: float = 0.5
    batch_factor: float = 0.5

    def tier(self, n_alive: int, n_total: int) -> str:
        frac = n_alive / max(n_total, 1)
        if frac < self.shed_below:
            return "shed_low_priority"
        if frac < self.shrink_batch_below:
            return "shrink_batch"
        if frac < self.reduce_tokens_below:
            return "reduce_tokens"
        return "full"

    @staticmethod
    def severity(tier: str) -> int:
        return TIERS.index(tier)

    # ------------------------------------------------- cumulative effects
    def token_cap(self, tier: str, max_tokens: int) -> int:
        """Generation-length ceiling under `tier` (>= 1)."""
        if self.severity(tier) >= TIERS.index("reduce_tokens"):
            return max(1, int(round(max_tokens * self.token_factor)))
        return max_tokens

    def batch_ceiling(self, tier: str, ceiling: int) -> int:
        """Per-replica concurrent-request ceiling under `tier` (>= 1)."""
        if self.severity(tier) >= TIERS.index("shrink_batch"):
            return max(1, int(round(ceiling * self.batch_factor)))
        return ceiling

    def sheds_low_priority(self, tier: str) -> bool:
        return tier == "shed_low_priority"
