"""§V-C — revocation characterization: per-(region, GPU) lifetime models with
time-of-day hazard modulation, calibrated to the paper's published fleet data
(Table V revocation rates, Fig 8 lifetime CDFs, Fig 9 diurnal patterns).

Lifetime = Weibull(k, λ) truncated at the 24 h maximum, scaled so
P(revoked < 24h) equals Table V's rate for that (region, GPU). The paper's
empirical CDFs are exposed via `cdf()` / `sample()` / `prob_revoked_within()`
— Eq (5) queries the latter.

The port's copy of the JAX package's `core/transient/revocation.py` (it
imports nothing of it), with `LifetimeModel`'s calibration-protocol methods
(`fit`, `predict`, `update`, `score`, `params_hash`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

MAX_LIFETIME_H = 24.0

# Table V: revocation % within 24h per (region, gpu); None = not offered.
TABLE5_RATES: Dict[Tuple[str, str], Optional[float]] = {
    ("us-east1", "k80"): 0.4667, ("us-east1", "p100"): 0.70,
    ("us-east1", "v100"): None,
    ("us-central1", "k80"): 0.5625, ("us-central1", "p100"): 0.5333,
    ("us-central1", "v100"): 0.6667,
    ("us-west1", "k80"): 0.2292, ("us-west1", "p100"): 0.6667,
    ("us-west1", "v100"): 0.7333,
    ("europe-west1", "k80"): 0.6667, ("europe-west1", "p100"): 0.2667,
    ("europe-west1", "v100"): None,
    ("europe-west4", "v100"): 0.43,
    ("asia-east1", "v100"): 0.47,
}

# Fig 8-informed shape/scale seeds: (weibull_k, mean_hint_hours).
# k<1 => front-loaded revocations (europe-west1 k80: >50% die in 2h);
# k>1 => later revocations (us-west1 k80: <5% in 2h, MTTR 19.8h).
_SHAPE_HINTS: Dict[Tuple[str, str], Tuple[float, float]] = {
    ("europe-west1", "k80"): (0.3, 10.6),   # >50% die in 2h, long tail
    ("us-west1", "k80"): (2.8, 19.8),
    ("us-central1", "k80"): (1.6, 14.0),
    ("us-east1", "k80"): (1.2, 12.0),
    ("us-central1", "v100"): (0.9, 7.7),
    ("us-west1", "v100"): (1.0, 8.5),
    ("europe-west4", "v100"): (1.3, 13.0),
    ("asia-east1", "v100"): (1.3, 12.5),
    ("us-east1", "p100"): (1.0, 9.0),
    ("us-central1", "p100"): (1.3, 12.0),
    ("us-west1", "p100"): (1.0, 9.5),
    ("europe-west1", "p100"): (1.8, 16.0),
}

# Fig 9: diurnal hazard multipliers (local hour). K80 peaks ~10AM;
# V100 has no revocations 4-8PM; P100 mildly business-hours-loaded.
# Upper bound on every weight, used as the thinning envelope.
_DIURNAL_MAX_WEIGHT = 2.5


def _diurnal_weight(gpu: str, hour) -> np.ndarray:
    """Vectorized over `hour` (scalar in, scalar-shaped array out)."""
    h = np.asarray(hour, float) % 24.0
    if gpu == "k80":
        return 1.0 + 1.5 * np.exp(-((h - 10.0) ** 2) / (2 * 2.0 ** 2))
    if gpu == "v100":
        w = 1.0 + 0.6 * np.exp(-((h - 9.0) ** 2) / (2 * 3.0 ** 2))
        return np.where((h >= 16.0) & (h < 20.0), 0.0, w)
    return 1.0 + 0.8 * np.exp(-((h - 13.0) ** 2) / (2 * 4.0 ** 2))


@dataclasses.dataclass
class LifetimeModel:
    """Truncated-Weibull lifetime with survival mass at 24h."""
    region: str
    gpu: str
    k: float
    lam: float
    p24: float  # P(revoked < 24h)

    #: uniform-block width for `sample_from_uniforms` (LifetimeLaw
    #: contract, repro/providers/base.py): 1 survival column + 16
    #: (candidate, accept) thinning pairs
    SAMPLE_UNIFORMS_K = 33

    @classmethod
    def calibrated(cls, region: str, gpu: str) -> "LifetimeModel":
        key = (region, gpu)
        rate = TABLE5_RATES.get(key)
        if rate is None:
            raise KeyError(f"{key} not offered in the paper's fleet")
        k, mean_hint = _SHAPE_HINTS.get(key, (1.2, 12.0))
        # λ from the mean hint of the *conditional* (revoked) lifetime;
        # Weibull mean = λ Γ(1+1/k)
        lam = mean_hint / math.gamma(1.0 + 1.0 / k)
        return cls(region, gpu, k, lam, rate)

    # CDF of the observable lifetime (with a point mass surviving to 24h)
    def cdf(self, t_hours: np.ndarray) -> np.ndarray:
        t = np.minimum(np.asarray(t_hours, float), MAX_LIFETIME_H)
        raw = 1.0 - np.exp(-((t / self.lam) ** self.k))
        raw24 = 1.0 - math.exp(-((MAX_LIFETIME_H / self.lam) ** self.k))
        return self.p24 * raw / max(raw24, 1e-12)

    def prob_revoked_within(self, t_hours: float) -> float:
        """Pr(R_i) for Eq (5): probability of revocation within t_hours."""
        return float(self.cdf(np.array([t_hours]))[0])

    def sample(self, rng: np.random.Generator, n: int = 1,
               start_hour: float = 0.0) -> np.ndarray:
        """Sample lifetimes in hours; np.inf = survived to the 24h cutoff.
        Thin wrapper over `sample_batch` (identical RNG stream at n=1)."""
        return self.sample_batch(rng, n, start_hour)

    def _inverse_cdf(self, uu: np.ndarray, raw24: float) -> np.ndarray:
        """Candidate revoked lifetimes from uniforms (truncated Weibull)."""
        return self.lam * (-np.log(1.0 - uu * raw24)) ** (1.0 / self.k)

    def sample_batch(self, rng: np.random.Generator, n: int,
                     start_hour: float = 0.0) -> np.ndarray:
        """Vectorized lifetime sampling; np.inf = survived to the 24h cutoff.

        Diurnal modulation is rejection sampling (thinning) on the hazard
        by the local-time weight. For n == 1 the rejection runs in the
        exact per-slot draw order of the pre-vectorization scalar loop, so
        fixed-seed golden values (provider parity tests) stay
        bit-identical. For n > 1 the thinning is *pooled*: candidates for
        every revoked slot are drawn and accept-tested as whole arrays
        (oversampled by the expected rejection rate), and accepted draws
        fill the slots in order — slots are iid, so the pooled scheme
        samples the identical distribution in a bounded handful of rounds
        instead of one Python round per rejection.
        """
        if n == 1:
            return self._sample_scalar(rng, 1, start_hour)
        u = rng.uniform(size=n)
        out = np.full(n, np.inf)
        revoked = u < self.p24
        m = int(np.count_nonzero(revoked))
        if m == 0:
            return out
        raw24 = 1.0 - math.exp(-((MAX_LIFETIME_H / self.lam) ** self.k))
        inv_env = 1.0 / _DIURNAL_MAX_WEIGHT
        vals = np.empty(m)
        got = 0
        for _ in range(16):
            need = m - got
            # ~1/E[w/2.5] candidates per still-empty slot, padded so one
            # round almost always suffices
            k = 3 * need + 16
            cand = self._inverse_cdf(rng.uniform(size=k), raw24)
            w = _diurnal_weight(self.gpu, start_hour + cand)
            acc = cand[rng.uniform(size=k) < w * inv_env]
            take = min(acc.size, need)
            vals[got:got + take] = acc[:take]
            got += take
            if got == m:
                break
        if got < m:
            # pathologically unlucky tail (the slot-wise loop's 64-round
            # cap, ~(1-p)^64): keep the last candidates, pushing any that
            # sit in a hard-zero window past it
            cand = self._inverse_cdf(rng.uniform(size=m - got), raw24)
            w = _diurnal_weight(self.gpu, start_hour + cand)
            vals[got:] = np.where(w == 0.0, cand + 4.0, cand)
        out[revoked] = np.minimum(vals, MAX_LIFETIME_H)
        return out

    def sample_from_uniforms(self, U: np.ndarray,
                             start_hours: np.ndarray) -> np.ndarray:
        """Vectorized lifetimes from a pre-drawn uniform block (the fleet
        engines' replacement-join path; see `LifetimeLaw` in
        repro/providers/base.py for the contract): column 0 decides the
        survival point mass, then up to 16 (candidate, accept) column
        pairs run the Fig 9 diurnal thinning per row — each row has its
        own local start hour, unlike `sample_batch`'s shared one. The
        16-round cap with the hard-zero push fallback mirrors the pooled
        rejection in `sample_batch`."""
        U = np.atleast_2d(np.asarray(U, float))
        hours = np.asarray(start_hours, float)
        m = U.shape[0]
        out = np.full(m, np.inf)
        revoked = U[:, 0] < self.p24
        if not revoked.any():
            return out
        idx = np.where(revoked)[0]
        h = hours[idx]
        raw24 = 1.0 - math.exp(-((MAX_LIFETIME_H / self.lam) ** self.k))
        inv_env = 1.0 / _DIURNAL_MAX_WEIGHT
        cand = self._inverse_cdf(U[idx, 1], raw24)
        pending = U[idx, 2] >= (_diurnal_weight(self.gpu, h + cand)
                                * inv_env)
        for j in range(1, 16):
            if not pending.any():
                break
            rows = np.where(pending)[0]
            c2 = self._inverse_cdf(U[idx[rows], 1 + 2 * j], raw24)
            cand[rows] = c2
            acc = (U[idx[rows], 2 + 2 * j]
                   < _diurnal_weight(self.gpu, h[rows] + c2) * inv_env)
            pending[rows] = ~acc
        if pending.any():
            rows = np.where(pending)[0]
            w = _diurnal_weight(self.gpu, h[rows] + cand[rows])
            cand[rows] = np.where(w == 0.0, cand[rows] + 4.0, cand[rows])
        out[idx] = np.minimum(cand, MAX_LIFETIME_H)
        return out

    def _sample_scalar(self, rng: np.random.Generator, n: int,
                       start_hour: float = 0.0) -> np.ndarray:
        """The pre-vectorization per-slot rejection loop, draw-for-draw:
        per round one acceptance uniform, then (if rejected) one resample
        uniform, 64-round cap with the hard-zero push. Kept verbatim as
        the n=1 dispatch target so fixed-seed goldens and interleaved
        scalar `lifetime()` streams stay bit-identical."""
        u = rng.uniform(size=n)
        out = np.full(n, np.inf)
        revoked = u < self.p24
        # inverse-CDF within the revoked mass
        uu = rng.uniform(size=n)
        raw24 = 1.0 - math.exp(-((MAX_LIFETIME_H / self.lam) ** self.k))
        t = self._inverse_cdf(uu, raw24)
        for i in np.where(revoked)[0]:
            accepted = False
            for _ in range(64):
                w = float(_diurnal_weight(self.gpu, start_hour + t[i]))
                if rng.uniform() < w / _DIURNAL_MAX_WEIGHT:
                    accepted = True
                    break
                t[i] = float(self._inverse_cdf(rng.uniform(), raw24))
            if not accepted and float(_diurnal_weight(
                    self.gpu, start_hour + t[i])) == 0.0:
                t[i] += 4.0  # hard-zero window: push past it
            out[i] = min(t[i], MAX_LIFETIME_H)
        return out

    def mean_time_to_revocation(self) -> float:
        """Conditional mean lifetime of revoked servers (Fig 8 discussion)."""
        ts = np.linspace(0, MAX_LIFETIME_H, 2000)
        c = self.cdf(ts) / max(self.p24, 1e-12)
        return float(np.trapezoid(1.0 - c, ts))

    # Estimator protocol (repro_torch.calibration) ------------------------
    @classmethod
    def fit(cls, region: str, gpu: str, lifetimes_h,
            k: Optional[float] = None) -> "LifetimeModel":
        """Censored fit from observed lifetimes (np.inf = survived 24h):
        p24 from the finite fraction, λ from the conditional mean of the
        revoked lifetimes, shape k kept from the Fig 8 hint (a Weibull
        shape needs far more data than a mid-run trace provides)."""
        lt = np.asarray(lifetimes_h, float)
        if lt.size == 0:
            raise ValueError("LifetimeModel.fit: no observed lifetimes")
        finite = lt[np.isfinite(lt)]
        p24 = min(max(finite.size / lt.size, 1e-3), 1.0 - 1e-3)
        if k is None:
            k = _SHAPE_HINTS.get((region, gpu), (1.2, 12.0))[0]
        mean_cond = (float(finite.mean()) if finite.size
                     else _SHAPE_HINTS.get((region, gpu), (1.2, 12.0))[1])
        lam = max(mean_cond, 1e-3) / math.gamma(1.0 + 1.0 / k)
        return cls(region, gpu, float(k), lam, p24)

    def predict(self, t_hours: float) -> float:
        return self.prob_revoked_within(t_hours)

    def update(self, lifetimes_h) -> "LifetimeModel":
        return type(self).fit(self.region, self.gpu, lifetimes_h, k=self.k)

    def score(self, lifetimes_h) -> dict:
        """Goodness-of-fit on the one quantity Eq (5) consumes: the 24h
        revocation probability, against the sample's finite fraction."""
        lt = np.asarray(lifetimes_h, float)
        if lt.size == 0:
            raise ValueError("LifetimeModel.score: no observed lifetimes")
        observed = float(np.isfinite(lt).mean())
        return {"n": int(lt.size), "mae": abs(observed - self.p24),
                "mape": abs(observed - self.p24)
                / max(observed, 1e-12) * 100.0}

    def params_hash(self) -> str:
        from repro_torch.calibration.estimator import params_hash
        return params_hash("lifetime", self.region, self.gpu, self.k,
                           self.lam, self.p24)


REGION_GPU_PARAMS = {key: LifetimeModel.calibrated(*key)
                     for key, rate in TABLE5_RATES.items() if rate is not None}


@dataclasses.dataclass
class RevocationSampler:
    """Fleet-level sampler used by the simulator and Eq (5).

    `provider` selects the market whose lifetime laws are sampled (a
    `repro_torch.providers` registry name or instance); the default reproduces
    the paper's GCP fleet bit-for-bit.
    """
    seed: int = 0
    provider: object = "gcp"

    def __post_init__(self):
        from repro_torch.providers import get_provider
        self.rng = np.random.default_rng(self.seed)
        self.provider = get_provider(self.provider)

    def lifetime(self, region: str, gpu: str, start_hour: float = 0.0) -> float:
        return float(self.lifetimes(region, gpu, 1, start_hour)[0])

    def lifetimes(self, region: str, gpu: str, n: int,
                  start_hour: float = 0.0) -> np.ndarray:
        """Batched lifetimes: resolves the lifetime model ONCE and draws
        `n` samples in one vectorized call — the Monte-Carlo hot path of
        the §V-C planner and the simulation ensemble."""
        m = self.provider.lifetime_model(region, gpu)
        return m.sample_batch(self.rng, n, start_hour)

    def prob_revoked_within(self, region: str, gpu: str,
                            t_hours: float) -> float:
        m = self.provider.lifetime_model(region, gpu)
        return m.prob_revoked_within(t_hours)
