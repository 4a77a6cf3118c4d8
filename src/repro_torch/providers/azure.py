"""Azure low-priority (spot) VM adapter.

What changes relative to the paper's GCP market (docs/providers.md):

* **Eviction-rate tiers** — Azure publishes per-(region, size) eviction
  rates in coarse buckets rather than continuous market prices; each
  offered cell is assigned a tier and modeled as a *memoryless* constant
  hazard (exponential lifetime) matching the tier's 24 h eviction
  probability. No diurnal structure: capacity-triggered evictions follow
  datacenter load balancing, not a visible price signal.
* **No lifetime cap** — like AWS and unlike GCP's 24 h ceiling.
* **30 s eviction notice** (Scheduled Events) — same length as GCP's, but
  delivered through a queryable metadata endpoint that checkpoint hooks
  poll, so the runtime is assumed to use it when T_c fits in the window.

Catalog: NC6 (K80), NC6s_v2 (P100), NC6s_v3 (V100) across four regions.

The port's copy of the JAX package's `providers/azure.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np

from repro_torch.providers.base import (FleetProvider, LifetimeLaw,
                                        Offering, ReplacementAnchors,
                                        StartupStages,
                                        conditional_mean_from_cdf)
from repro_torch.providers.registry import register_provider

# Eviction-rate tiers: portal bucket label -> P(evicted within 24 h).
EVICTION_TIERS: Dict[str, float] = {
    "0-5%": 0.05, "5-10%": 0.10, "10-15%": 0.15,
    "15-20%": 0.20, "20%+": 0.30,
}

AZURE_HORIZON_H = 168.0


@dataclasses.dataclass
class TieredEvictionLifetime(LifetimeLaw):
    """Constant-hazard (exponential) lifetime from an eviction-rate tier."""
    region: str
    gpu: str
    tier: str
    horizon_h: float = AZURE_HORIZON_H

    def __post_init__(self):
        self.p24 = EVICTION_TIERS[self.tier]
        self.hazard_per_h = -math.log(1.0 - self.p24) / 24.0

    def cdf(self, t_hours: np.ndarray) -> np.ndarray:
        # saturate at the sampling horizon so the closed form agrees with
        # sample()'s "inf = survived the horizon" convention (Eq (5)
        # predictions vs MC/simulation consistency)
        t = np.minimum(np.asarray(t_hours, float), self.horizon_h)
        return 1.0 - np.exp(-self.hazard_per_h * t)

    def prob_revoked_within(self, t_hours: float) -> float:
        return float(self.cdf(np.array([t_hours]))[0])

    def sample(self, rng: np.random.Generator, n: int = 1,
               start_hour: float = 0.0) -> np.ndarray:
        # memoryless: start_hour is irrelevant by construction
        t = rng.exponential(1.0 / self.hazard_per_h, size=n)
        return np.where(t > self.horizon_h, np.inf, t)

    def params_hash(self) -> str:
        # override the LifetimeLaw default: the tier resolves to the
        # fitted (p24, hazard) pair — hash those, not just the label
        from repro_torch.calibration.estimator import params_hash
        return params_hash("tiered_eviction", self.region, self.gpu,
                           self.tier, self.horizon_h, self.p24,
                           self.hazard_per_h)

    #: single-column consumption: one uniform through the inverse
    #: exponential CDF (keeps the engines' pre-drawn pools minimal)
    SAMPLE_UNIFORMS_K = 1

    def sample_from_uniforms(self, U: np.ndarray,
                             start_hours: np.ndarray) -> np.ndarray:
        """Fleet-engine replacement-join sampler (LifetimeLaw contract):
        inverse-transform exponential of column 0 — same distribution as
        `sample`'s ziggurat draw, deterministic in the uniform block.
        Memoryless, so `start_hours` is irrelevant by construction."""
        U = np.atleast_2d(np.asarray(U, float))
        t = -np.log(1.0 - U[:, 0]) / self.hazard_per_h
        return np.where(t > self.horizon_h, np.inf, t)

    def mean_time_to_revocation(self) -> float:
        p_h = self.prob_revoked_within(self.horizon_h)
        return conditional_mean_from_cdf(self.cdf, p_h, self.horizon_h)


# (region, gpu) -> eviction tier. GPU capacity is scarcest in eastus;
# southeastasia NC pools are small and churn the most.
LP_MARKETS: Dict[Tuple[str, str], str] = {
    ("eastus", "k80"): "10-15%",
    ("eastus", "p100"): "15-20%",
    ("eastus", "v100"): "20%+",
    ("southcentralus", "k80"): "5-10%",
    ("southcentralus", "p100"): "10-15%",
    ("southcentralus", "v100"): "15-20%",
    ("westeurope", "k80"): "0-5%",
    ("westeurope", "p100"): "5-10%",
    ("westeurope", "v100"): "10-15%",
    ("southeastasia", "k80"): "15-20%",
    ("southeastasia", "v100"): "20%+",
}

# per-GPU-server $/h: (pay-as-you-go, low-priority) — NC6 / NC6s_v2 / v3
_PRICES = {"k80": (0.90, 0.18), "p100": (2.07, 0.414),
           "v100": (3.06, 0.612)}

# Azure VM allocation is the slow stage (fabric placement), staging is
# comparable to GCP; low-priority adds allocation retries.
_STAGES = {"k80": StartupStages(41.0, 36.0, 15.0, 10.0),
           "p100": StartupStages(43.0, 40.0, 15.0, 14.0),
           "v100": StartupStages(45.0, 42.0, 15.0, 15.0)}


class AzureLowPriority(FleetProvider):
    name = "azure"
    display_name = "Azure low-priority"
    warning_seconds = 30.0        # Scheduled Events eviction notice
    max_lifetime_hours = math.inf
    graceful_checkpoint_on_warning = True
    default_region = "southcentralus"

    def __init__(self):
        self._laws = {key: TieredEvictionLifetime(key[0], key[1], tier)
                      for key, tier in LP_MARKETS.items()}

    def offerings(self) -> Tuple[Offering, ...]:
        return tuple(Offering(r, g) for (r, g) in LP_MARKETS)

    def lifetime_model(self, region: str, gpu: str) -> LifetimeLaw:
        self.check_offered(region, gpu)
        return self._laws[(region, gpu)]

    def eviction_tier(self, region: str, gpu: str) -> str:
        self.check_offered(region, gpu)
        return LP_MARKETS[(region, gpu)]

    def startup_stages(self, gpu: str) -> StartupStages:
        return _STAGES[gpu]

    def replacement_anchors(self) -> ReplacementAnchors:
        # managed-disk reattach makes cold rejoin slowest of the three
        return ReplacementAnchors(88.9, 17.5, 0.72)

    def price(self, gpu: str, transient: bool = True) -> float:
        payg, lp = _PRICES[gpu]
        return lp if transient else payg


AZURE = register_provider(AzureLowPriority())
