"""§V-D/E — worker replacement overhead (cold vs warm start, Fig 10) and the
stock-framework recomputation pathology (Fig 11).

Cold start = new server: framework start + join + dataset download + graph
setup. Warm start = existing server rejoining: framework restart only.
Both grow with model complexity (graph-setup dominated). The recomputation
overhead of re-using the revoked chief's identity is bounded by the
checkpoint interval; CM-DARE's handover removes it (core/checkpoint lease).

The port's copy of the JAX package's `core/transient/replacement.py` (it
imports nothing of it).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Fig 10 anchors (seconds) for ResNet-15 and Shake-Shake-Big on K80
_COLD_BASE = 75.6
_WARM_BASE = 14.8
_COMPLEXITY_SLOPE = 0.72   # s per GFLOP of model complexity (graph setup)


@dataclasses.dataclass
class ReplacementModel:
    """Rejoin-time sampler; `provider` selects whose cold/warm anchors are
    used (the default is the paper's Fig 10 GCP calibration)."""
    seed: int = 0
    provider: object = "gcp"

    def __post_init__(self):
        from repro_torch.providers import get_provider
        self.rng = np.random.default_rng(self.seed)
        self._anchors = get_provider(self.provider).replacement_anchors()

    def cold_start_s(self, c_m_gflops: float) -> float:
        return self._anchors.cold_start_s(c_m_gflops)

    def warm_start_s(self, c_m_gflops: float) -> float:
        return self._anchors.warm_start_s(c_m_gflops)

    def sample(self, c_m_gflops: float, cold: bool = True) -> float:
        mean = (self.cold_start_s if cold else self.warm_start_s)(c_m_gflops)
        return float(max(1.0, self.rng.normal(mean, 0.05 * mean)))
