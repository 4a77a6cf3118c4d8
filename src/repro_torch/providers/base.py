"""`FleetProvider` — the per-cloud contract behind CM-DARE's fleet models.

The paper measured one market (GCP preemptible, §V); everything the
measurement loop calibrated there — which (region, GPU) cells exist, how
long servers live before revocation, how long they take to start and to
rejoin a job, and what they cost per hour — is exactly what differs between
transient markets. A `FleetProvider` owns those five things, so the Eq (4)/
(5) machinery, the launch planner and the fleet simulator run unchanged on
any market (docs/providers.md walks through adding one).

Contract summary (docs/DESIGN.md §5):

  offerings()            which (region, gpu) cells the market sells
  lifetime_model(r, g)   a `LifetimeLaw` for that cell (revocation CDF)
  startup_stages(g)      provisioning/staging/running stage means (§V-B)
  replacement_anchors()  cold/warm rejoin-time anchors (Fig 10)
  price(g)               hourly $ (transient and on-demand)

plus three scalars that shape simulation semantics: `warning_seconds`
(revocation notice length), `max_lifetime_hours` (GCP's 24 h cap; `inf`
for uncapped markets) and `graceful_checkpoint_on_warning` (whether the
runtime is assumed to flush a checkpoint inside the notice window — the
paper observed stock frameworks do NOT react to GCP's 30 s notice).

The port's copy of the JAX package's `providers/base.py` (it imports
nothing of it), with the calibration-protocol surface of `LifetimeLaw`
(`residuals`, `score`, `params_hash`).
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np


class LifetimeLaw(abc.ABC):
    """Distribution of one (region, gpu) cell's transient-server lifetime.

    `sample` returns hours, with `np.inf` meaning "survived the sampling
    horizon" (the 24 h cap on GCP; a soft horizon on uncapped markets).
    """

    @abc.abstractmethod
    def cdf(self, t_hours: np.ndarray) -> np.ndarray:
        """P(lifetime <= t) for an array of horizons (hours)."""

    @abc.abstractmethod
    def prob_revoked_within(self, t_hours: float) -> float:
        """Pr(R_i) for Eq (5): probability of revocation within t_hours."""

    @abc.abstractmethod
    def sample(self, rng: np.random.Generator, n: int = 1,
               start_hour: float = 0.0) -> np.ndarray:
        """Sample lifetimes (hours); np.inf = survived the horizon."""

    def sample_batch(self, rng: np.random.Generator, n: int,
                     start_hour: float = 0.0) -> np.ndarray:
        """Batched sampling for the Monte-Carlo engine. The default
        delegates to `sample`, which every built-in adapter already
        implements as a vectorized draw; override only when the batched
        path differs from the scalar one (e.g. GCP's diurnal thinning)."""
        return self.sample(rng, int(n), start_hour)

    #: Columns of the pre-drawn uniform block `sample_from_uniforms`
    #: may consume per lifetime (the fleet engines pre-draw
    #: (trajectories, slots, SAMPLE_UNIFORMS_K) pools per replacement
    #: generation).
    SAMPLE_UNIFORMS_K: int = 33

    #: Optional vectorized sampler from pre-drawn uniforms — the fleet
    #: engines' replacement-join path (fleet_batched.FleetDraws). Set to
    #: a method `(U: (m, K) uniforms, start_hours: (m,) local hours) ->
    #: (m,) lifetimes` that is a *deterministic function of U* with the
    #: same distribution as `sample` (the draw path may differ, e.g.
    #: inverse-transform instead of ziggurat exponentials), vectorized
    #: over per-sample start hours. Leave as None and the engines fall
    #: back to one counter-based RNG stream per replacement — correct
    #: for any custom law, just slower.
    sample_from_uniforms = None

    @abc.abstractmethod
    def mean_time_to_revocation(self) -> float:
        """Conditional mean lifetime of revoked servers (hours)."""

    # ------------------------------------------- Estimator-protocol surface
    def residuals(self, lifetimes_h) -> np.ndarray:
        """Fit residuals against observed lifetimes: for each finite
        observation, empirical CDF minus model CDF at that point (signed;
        positive = the law under-predicts early revocations). The
        calibration layer uses these to decide whether a law still
        matches the market it was fit on."""
        lt = np.asarray(lifetimes_h, float)
        finite = np.sort(lt[np.isfinite(lt)])
        if finite.size == 0:
            return np.empty(0)
        # Hazen plotting positions for the empirical CDF, scaled by the
        # finite fraction so the survival mass is accounted for
        emp = (np.arange(1, finite.size + 1) - 0.5) / lt.size
        return emp - np.asarray(self.cdf(finite), float)

    def score(self, lifetimes_h) -> Dict[str, float]:
        """Goodness-of-fit summary over `residuals` (Estimator protocol)."""
        r = self.residuals(lifetimes_h)
        if r.size == 0:
            raise ValueError("LifetimeLaw.score: no finite lifetimes")
        return {"n": int(r.size), "mae": float(np.abs(r).mean()),
                "max_abs": float(np.abs(r).max())}

    def params_hash(self) -> str:
        """Stable digest of the law's fitted parameters. The default
        hashes every public scalar/array field in name order; laws with
        non-field state (hazard grids, caches) override this."""
        from repro_torch.calibration.estimator import params_hash as _phash
        parts: list = [type(self).__name__]
        fields = (dataclasses.fields(self)
                  if dataclasses.is_dataclass(self) else None)
        names = ([f.name for f in fields] if fields is not None
                 else sorted(k for k in vars(self) if not k.startswith("_")))
        for name in names:
            v = getattr(self, name)
            if isinstance(v, (str, int, float, np.ndarray)):
                parts.extend([name, v])
        return _phash(*parts)


@dataclasses.dataclass(frozen=True)
class Offering:
    """One sellable (region, gpu) cell of a transient market."""
    region: str
    gpu: str


@dataclasses.dataclass(frozen=True)
class StartupStages:
    """§V-B startup decomposition: mean seconds per stage for transient
    servers, plus how much faster the on-demand staging stage is."""
    provisioning: float
    staging: float
    running: float
    ondemand_staging_discount: float = 0.0

    def means(self, transient: bool = True) -> Tuple[float, float, float]:
        s = self.staging
        if not transient:
            s = max(5.0, s - self.ondemand_staging_discount)
        return self.provisioning, s, self.running


@dataclasses.dataclass(frozen=True)
class ReplacementAnchors:
    """Fig 10 rejoin-overhead anchors: seconds = base + slope * C_m."""
    cold_base: float
    warm_base: float
    complexity_slope: float

    def cold_start_s(self, c_m_gflops: float) -> float:
        return self.cold_base + self.complexity_slope * c_m_gflops

    def warm_start_s(self, c_m_gflops: float) -> float:
        return self.warm_base + 0.5 * self.complexity_slope * c_m_gflops


class FleetProvider(abc.ABC):
    """One transient-GPU market: offerings, lifetimes, startup, pricing."""

    #: registry key (``--provider`` value), e.g. ``"gcp"``
    name: str = ""
    #: human-readable market name for reports
    display_name: str = ""
    #: seconds of revocation notice the market gives
    warning_seconds: float = 0.0
    #: hard lifetime cap in hours (math.inf when the market has none)
    max_lifetime_hours: float = math.inf
    #: whether the runtime checkpoints inside the warning window when the
    #: notice is long enough (>= T_c); False reproduces the paper's stock
    #: behavior of ignoring the notice
    graceful_checkpoint_on_warning: bool = False
    #: region used when a caller does not pick one
    default_region: str = ""

    # ------------------------------------------------------------- catalog
    @abc.abstractmethod
    def offerings(self) -> Tuple[Offering, ...]:
        """Every sellable (region, gpu) cell."""

    def regions_offering(self, gpu: str) -> List[str]:
        return sorted({o.region for o in self.offerings() if o.gpu == gpu})

    def gpus(self) -> List[str]:
        return sorted({o.gpu for o in self.offerings()})

    def is_offered(self, region: str, gpu: str) -> bool:
        # cached: this sits in the MC-planner/simulator hot loop (one
        # check per lifetime sample); the catalog is immutable
        cache = getattr(self, "_offerings_cache", None)
        if cache is None:
            cache = frozenset(self.offerings())
            self._offerings_cache = cache
        return Offering(region, gpu) in cache

    def check_gpu_offered(self, gpu: str) -> None:
        """Raise ValueError naming this market's GPUs when `gpu` is sold
        in no region (the single source of that error message)."""
        if not self.regions_offering(gpu):
            raise ValueError(
                f"{self.display_name or self.name} does not offer {gpu!r}; "
                f"available GPUs: {self.gpus()}")

    def check_offered(self, region: str, gpu: str) -> None:
        """Raise ValueError naming the alternatives when a cell is not
        sold — mirrors Session._check_fleet's error style."""
        if self.is_offered(region, gpu):
            return
        self.check_gpu_offered(gpu)
        raise ValueError(
            f"({region!r}, {gpu!r}) is not offered by "
            f"{self.display_name or self.name}; regions with {gpu}: "
            f"{self.regions_offering(gpu)}")

    # -------------------------------------------------------------- models
    @abc.abstractmethod
    def lifetime_model(self, region: str, gpu: str) -> LifetimeLaw:
        """The revocation-lifetime law of one offered cell."""

    @abc.abstractmethod
    def startup_stages(self, gpu: str) -> StartupStages:
        """§V-B provisioning/staging/running stage means for `gpu`."""

    @abc.abstractmethod
    def replacement_anchors(self) -> ReplacementAnchors:
        """Fig 10 cold/warm rejoin anchors for this market's images."""

    # ------------------------------------------------------------- pricing
    @abc.abstractmethod
    def price(self, gpu: str, transient: bool = True) -> float:
        """Hourly price per server ($/h)."""

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<FleetProvider {self.name}>"


def conditional_mean_from_cdf(cdf, p_total: float,
                              horizon_hours: float) -> float:
    """Mean lifetime of revoked servers from a CDF: E[T | T <= horizon],
    shared by adapters whose laws have no closed-form mean."""
    ts = np.linspace(0.0, horizon_hours, 2000)
    c = np.asarray(cdf(ts), float) / max(p_total, 1e-12)
    return float(np.trapezoid(1.0 - np.clip(c, 0.0, 1.0), ts))
