"""Replica state machine + the revocable fleet model behind it.

A serving replica lives on a transient instance: it is ACTIVE (admitting
and decoding), DRAINING (a revocation notice arrived — it finishes what
it holds but admits nothing new), or DOWN (revoked; a replacement is
provisioning). The invariant the property tests pin: **a replica admits
if and only if it is ACTIVE** — a drained or down replica never takes a
request, however briefly.

`ReplicaSet` compiles the fleet against a provider exactly the way the
training `FleetSim` does: per-(trajectory, slot, generation) lifetimes
from keyed counter-based streams (bit-identical whichever engine asks,
in whatever order), optionally thinned by a chaos `FaultTimeline`'s
hazard windows, and a deterministic replacement delay from the §V-B
`StartupModel` stage means.

The port's copy of the JAX package's `serving/replica.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

ACTIVE, DRAINING, DOWN = "active", "draining", "down"

#: stream tag for replica lifetime draws (cf. injectors._TAG_INITIAL)
_TAG_LIFETIME = 0x5EF1E


@dataclasses.dataclass
class Replica:
    """One serving slot's current incarnation."""
    slot: int
    gen: int = 0
    status: str = ACTIVE
    joined_s: float = 0.0
    death_s: float = math.inf     # revocation instant
    drain_s: float = math.inf     # notice instant (death - warning), if any
    rejoin_s: float = math.inf    # replacement join instant while DOWN
    drained: bool = False         # notice already processed

    def can_admit(self) -> bool:
        """The admission invariant: ACTIVE only — never while draining,
        never while down."""
        return self.status == ACTIVE

    def start_drain(self) -> None:
        if self.status == ACTIVE:
            self.status = DRAINING
        self.drained = True

    def kill(self, now: float, startup_s: float) -> None:
        self.status = DOWN
        self.rejoin_s = now + startup_s

    def rejoin(self, now: float, lifetime_s: float,
               warning_s: float) -> None:
        self.gen += 1
        self.status = ACTIVE
        self.joined_s = now
        self.death_s = now + lifetime_s
        # clamp to `now`: a replacement living shorter than the warning
        # window must not schedule its drain notice in the past
        self.drain_s = (max(now, self.death_s - warning_s)
                        if warning_s > 0 else math.inf)
        self.rejoin_s = math.inf
        self.drained = False


class ReplicaSet:
    """`n` replicas on one provider's (region, gpu) cell.

    Owns the keyed lifetime streams and the chaos thinning so the event
    and batched simulator engines consume identical revocation times.
    `seed` is the scenario seed (not the per-trajectory one) — the same
    convention as `FaultTimeline`.
    """

    def __init__(self, n: int, provider, region: Optional[str] = None,
                 gpu: str = "v100", seed: int = 0, chaos=None):
        from repro_torch.core.transient.startup import StartupModel
        from repro_torch.providers import get_provider

        if n < 1:
            raise ValueError(f"need at least one replica, got {n}")
        self.n = int(n)
        self.provider = get_provider(provider)
        self.region = region or self.provider.default_region
        self.gpu = gpu
        self.provider.check_offered(self.region, gpu)
        self.seed = int(seed) % (2 ** 32)
        self.law = self.provider.lifetime_model(self.region, gpu)
        #: deterministic replacement delay (mean of the §V-B stages) —
        #: stochastic startup would add nothing to the serving story but
        #: would complicate the two-engine parity contract
        self.startup_s = StartupModel(seed, self.provider).mean_total(gpu)
        self.warning_s = float(self.provider.warning_seconds)
        self.price_per_h = self.provider.price(gpu)
        self.chaos = chaos

    # ------------------------------------------------------------- roster
    def roster(self) -> List[Tuple[int, str, str, float]]:
        """(wid, gpu, region, speed) tuples — the `FaultTimeline` shape."""
        return [(i, self.gpu, self.region, 1.0) for i in range(self.n)]

    # ---------------------------------------------------------- lifetimes
    def _raw_lifetime_h(self, traj: int, slot: int, gen: int,
                        start_hour: float) -> float:
        rng = np.random.default_rng(np.random.SeedSequence(
            (self.seed, _TAG_LIFETIME, int(traj), int(slot), int(gen))))
        return float(self.law.sample(rng, 1, start_hour=start_hour)[0])

    def initial_lifetimes_h(self, n_traj: int) -> np.ndarray:
        """(n_traj, n) hour matrix for generation 0, chaos-thinned. Drawn
        per (traj, slot) keyed stream, then transformed once as a matrix
        — `FaultTimeline.transform_initial`'s contract."""
        lt = np.array([[self._raw_lifetime_h(tj, sl, 0, 0.0)
                        for sl in range(self.n)] for tj in range(n_traj)])
        if self.chaos is not None:
            lt = self.chaos.transform_initial(lt)
        return lt

    def replacement_lifetime_h(self, traj: int, slot: int, gen: int,
                               elapsed_h: float) -> float:
        """One replacement's lifetime (hours), chaos-thinned at its join
        time. Keyed per (traj, slot, gen): identical whichever engine
        asks first."""
        lt = self._raw_lifetime_h(traj, slot, gen, elapsed_h % 24.0)
        if self.chaos is not None:
            lt = float(self.chaos.transform_joins(
                np.array([lt]), np.array([traj]), np.array([slot]),
                np.array([gen]), np.array([elapsed_h]))[0])
        return lt

    def fresh(self, traj: int, lifetimes_h: np.ndarray,
              warned: bool) -> List[Replica]:
        """Generation-0 replicas for one trajectory. `warned` arms the
        drain notice (resilience on a market that gives warnings)."""
        out = []
        for sl in range(self.n):
            death = float(lifetimes_h[sl]) * 3600.0
            r = Replica(slot=sl, death_s=death)
            if warned and self.warning_s > 0 and math.isfinite(death):
                r.drain_s = max(0.0, death - self.warning_s)
            out.append(r)
        return out
