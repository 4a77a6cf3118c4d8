"""AWS EC2 Spot adapter.

What changes relative to the paper's GCP market (docs/providers.md):

* **No 24 h lifetime cap** — spot instances run until the market reclaims
  them, so the lifetime law is an *uncapped* non-homogeneous hazard rather
  than GCP's truncated Weibull with a point mass at 24 h.
* **Price-signal-driven hazard** — interruptions happen when the spot
  price (demand) rises through the fleet's bid, so the hazard follows a
  diurnal demand signal per region: lambda(t) = base * signal(local hour).
  Base rates are calibrated to Spot-Advisor-style interruption-frequency
  buckets (probability of interruption within 24 h).
* **2-minute interruption notice** — long enough for an interruption
  handler to flush a checkpoint (`graceful_checkpoint_on_warning=True`),
  unlike the 30 s GCP notice stock frameworks ignore (§V).

Catalog note: AWS never sold P100s — K80s are p2.* and V100s are p3.*,
which is why `p100` is absent from this market's offerings.

The port's copy of the JAX package's `providers/aws.py` (it imports nothing
of it).
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

# Sampling horizon for the uncapped law: lifetimes beyond this return inf
# ("survived the simulated window"), mirroring GCP's 24 h point mass.
SPOT_HORIZON_H = 168.0


def demand_signal(hour, peak_hour: float, amplitude: float):
    """Relative spot-price/demand level at a local hour (scalar or array):
    a business-hours bump on a flat base (max value 1 + amplitude)."""
    h = np.asarray(hour, float) % 24.0
    d = np.minimum(np.abs(h - peak_hour), 24.0 - np.abs(h - peak_hour))
    return 1.0 + amplitude * np.exp(-(d ** 2) / (2 * 3.5 ** 2))


@dataclasses.dataclass
class PriceSignalLifetime(LifetimeLaw):
    """Uncapped lifetime under a diurnal price-driven hazard.

    hazard(t) = base_hazard * demand_signal(start_hour + t); the CDF and
    inverse are computed on a time grid (no closed form).
    """
    region: str
    gpu: str
    p24: float            # interruption probability within 24 h (advisor)
    peak_hour: float
    amplitude: float
    horizon_h: float = SPOT_HORIZON_H

    def __post_init__(self):
        # base hazard so that the *average-signal* 24 h survival matches
        # the advisor bucket: integral of hazard over 24 h = -ln(1-p24)
        mean_sig = float(np.mean(demand_signal(
            np.linspace(0.0, 24.0, 97), self.peak_hour, self.amplitude)))
        self.base_hazard = -math.log(max(1.0 - self.p24, 1e-9)) \
            / (24.0 * mean_sig)
        # the cumulative-hazard grid only depends on the launch hour mod
        # 24 — cache it so MC planning (200 samples per cell) does not
        # rebuild an identical grid per sample
        self._grid_cache: Dict[float, Tuple[np.ndarray, np.ndarray]] = {}

    def _grid(self, start_hour: float) -> Tuple[np.ndarray, np.ndarray]:
        # quantize the launch hour to 15 min: bounds the cache at 96
        # entries and lets simulator join events (continuous start_hour)
        # hit it; well within the hazard model's fidelity
        key = round(float(start_hour) % 24.0 * 4.0) / 4.0
        hit = self._grid_cache.get(key)
        if hit is None:
            ts = np.linspace(0.0, self.horizon_h, 2048)
            lam = self.base_hazard * demand_signal(
                key + ts, self.peak_hour, self.amplitude)
            cum = np.concatenate([[0.0], np.cumsum(
                0.5 * (lam[1:] + lam[:-1]) * np.diff(ts))])
            hit = self._grid_cache[key] = (ts, cum)
        return hit

    def cdf(self, t_hours: np.ndarray, start_hour: float = 0.0) -> np.ndarray:
        ts, cum = self._grid(start_hour)
        lam_t = np.interp(np.asarray(t_hours, float), ts, cum)
        return 1.0 - np.exp(-lam_t)

    def prob_revoked_within(self, t_hours: float) -> float:
        return float(self.cdf(np.array([t_hours]))[0])

    def sample(self, rng: np.random.Generator, n: int = 1,
               start_hour: float = 0.0) -> np.ndarray:
        ts, cum = self._grid(start_hour)
        target = -np.log(1.0 - rng.uniform(size=n))
        # right=np.inf: targets beyond the horizon's cumulative hazard
        # survived the sampling window
        return np.interp(target, cum, ts, right=np.inf)

    def params_hash(self) -> str:
        # override the LifetimeLaw default: include the derived
        # base_hazard (the fitted quantity) and skip the grid cache
        from repro_torch.calibration.estimator import params_hash
        return params_hash("price_signal", self.region, self.gpu, self.p24,
                           self.peak_hour, self.amplitude, self.horizon_h,
                           self.base_hazard)

    #: single-column consumption: one uniform through the inverse
    #: cumulative hazard (keeps the engines' pre-drawn pools minimal)
    SAMPLE_UNIFORMS_K = 1

    def sample_from_uniforms(self, U: np.ndarray,
                             start_hours: np.ndarray) -> np.ndarray:
        """Fleet-engine replacement-join sampler (LifetimeLaw contract):
        inverse cumulative hazard of column 0, per-row launch hour. Rows
        are grouped by the 15-min-quantized hazard grid their hour maps
        to, so the cache behaves exactly as under `sample`."""
        U = np.atleast_2d(np.asarray(U, float))
        hours = np.asarray(start_hours, float)
        target = -np.log(1.0 - U[:, 0])
        out = np.empty(len(target))
        keys = np.round(hours % 24.0 * 4.0) / 4.0
        for key in np.unique(keys):
            rows = keys == key
            ts, cum = self._grid(float(key))
            out[rows] = np.interp(target[rows], cum, ts, right=np.inf)
        return out

    def mean_time_to_revocation(self) -> float:
        p_h = self.prob_revoked_within(self.horizon_h)
        return conditional_mean_from_cdf(self.cdf, p_h, self.horizon_h)


# (region, gpu) -> (p24 interruption bucket, demand peak local hour,
# demand amplitude). p2=K80, p3=V100; no P100 SKU ever existed on EC2.
SPOT_MARKETS: Dict[Tuple[str, str], Tuple[float, float, float]] = {
    ("us-east-1", "k80"): (0.20, 11.0, 0.9),
    ("us-east-1", "v100"): (0.45, 13.0, 1.4),   # chronically tight p3 pool
    ("us-west-2", "k80"): (0.12, 10.0, 0.7),
    ("us-west-2", "v100"): (0.32, 12.0, 1.1),
    ("eu-west-1", "k80"): (0.16, 9.0, 0.8),
    ("eu-west-1", "v100"): (0.26, 10.0, 1.0),
    ("ap-northeast-1", "v100"): (0.38, 14.0, 1.2),
}

# per-GPU-server $/h: (on-demand, typical spot) — p2.xlarge / p3.2xlarge
_PRICES = {"k80": (0.90, 0.27), "v100": (3.06, 0.918)}

# Spot fulfillment adds a capacity-evaluation step to provisioning and the
# AMI/EBS warm-up dominates staging.
_STAGES = {"k80": StartupStages(32.0, 31.0, 12.0, 9.0),
           "v100": StartupStages(36.0, 34.0, 12.0, 12.0)}


class AWSSpot(FleetProvider):
    name = "aws"
    display_name = "AWS EC2 Spot"
    warning_seconds = 120.0       # the 2-minute interruption notice
    max_lifetime_hours = math.inf
    graceful_checkpoint_on_warning = True
    default_region = "us-east-1"

    def __init__(self):
        self._laws = {key: PriceSignalLifetime(key[0], key[1], *params)
                      for key, params in SPOT_MARKETS.items()}

    def offerings(self) -> Tuple[Offering, ...]:
        return tuple(Offering(r, g) for (r, g) in SPOT_MARKETS)

    def lifetime_model(self, region: str, gpu: str) -> LifetimeLaw:
        self.check_offered(region, gpu)
        return self._laws[(region, gpu)]

    def startup_stages(self, gpu: str) -> StartupStages:
        return _STAGES[gpu]

    def replacement_anchors(self) -> ReplacementAnchors:
        # heavier base image pull than GCP's minimal images, same
        # graph-setup complexity slope (framework-side, cloud-agnostic)
        return ReplacementAnchors(82.4, 16.1, 0.72)

    def price(self, gpu: str, transient: bool = True) -> float:
        od, spot = _PRICES[gpu]
        return spot if transient else od


AWS = register_provider(AWSSpot())
