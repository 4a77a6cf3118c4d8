"""§V-B — transient server startup time: provisioning → staging → running
stages (Fig 6), revocation-adjacency effects (Fig 7).

Calibrated to the paper's findings: total < 100 s; transient slower than
on-demand by ~11 s (K80) / ~21 s (P100); staging dominates the K80/P100 gap;
immediate-after-revocation requests have ~4x the variance but the same mean.

The port's copy of the JAX package's `core/transient/startup.py` (it
imports nothing of it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

# (provision_mean, staging_mean, running_mean) seconds, transient servers
_STAGE_MEANS: Dict[str, Tuple[float, float, float]] = {
    "k80": (21.0, 38.0, 14.0),      # longer, more variable staging
    "p100": (23.0, 44.5, 14.0),     # ~8.7% slower overall than k80
    "v100": (24.0, 46.0, 14.0),
    "v5e": (30.0, 55.0, 20.0),      # TPU slice analogue
}
_ONDEMAND_DISCOUNT = {"k80": 11.14, "p100": 21.38, "v100": 21.0, "v5e": 25.0}
BASE_COV = 0.03
#: 4x higher CoV right after a revocation (Fig 7) — shared with the
#: batched engine's pre-drawn delay pools (fleet_batched.FleetDraws)
POST_REVOCATION_COV = 0.12


@dataclasses.dataclass
class StartupModel:
    """Per-stage startup sampler; `provider` selects whose stage-mean table
    is used (the default is the paper's GCP calibration, bit-for-bit)."""
    seed: int = 0
    provider: object = "gcp"

    def __post_init__(self):
        from repro_torch.providers import get_provider
        self.rng = np.random.default_rng(self.seed)
        self.provider = get_provider(self.provider)

    def stage_means(self, gpu: str, transient: bool = True):
        return self.provider.startup_stages(gpu).means(transient)

    def mean_total(self, gpu: str, transient: bool = True) -> float:
        return float(sum(self.stage_means(gpu, transient)))

    def sample(self, gpu: str, transient: bool = True,
               after_revocation: bool = False) -> Dict[str, float]:
        cov = POST_REVOCATION_COV if after_revocation else BASE_COV
        out = {}
        for name, mean in zip(("provisioning", "staging", "running"),
                              self.stage_means(gpu, transient)):
            out[name] = float(max(1.0, self.rng.normal(mean, cov * mean)))
        out["total"] = sum(out.values())
        return out
