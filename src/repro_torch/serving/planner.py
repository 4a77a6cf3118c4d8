"""Serving fleet planner: score (replica_count, provider, region) cells
against a latency SLO with the batched serving simulator.

The serving analogue of `core.scheduler.plan_launch`: instead of asking
"which (region, launch-hour) finishes N training steps cheapest", it asks
"which fleet shape serves this request stream inside the p99 SLO at the
lowest $/1k completed requests". Every cell is scored by a full
`ServingFleetSim` ensemble — realized pooled p50/p99 latency, shed and
drop fractions, revocation counts and replica-hours cost — so the ranking
prices in each market's revocation law and warning contract, not just its
hourly rate.

Ranking is SLO-first, then cheapest: cells meeting the SLO sort above
cells that miss it, and within each group by $/1k completed requests
(ties: lower p99, fewer replicas, then provider/region name — fully
deterministic, which the pinned golden-ranking test relies on).

The port's copy of the JAX package's `serving/planner.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.degradation import ServingDegradationPolicy
from repro_torch.serving.replica import ReplicaSet
from repro_torch.serving.simulator import (ServingFleetSim,
                                           ServingWorkload,
                                           summarize_serving)


@dataclasses.dataclass(frozen=True)
class ServingSLO:
    """What the fleet owes the workload."""
    p99_latency_s: float = 10.0
    max_shed_frac: float = 0.1        # admission-control 429s tolerated
    max_drop_frac: float = 0.0        # in-flight losses tolerated


@dataclasses.dataclass
class ServingPlan:
    """One scored (replicas, provider, region) cell."""
    provider: str
    region: str
    gpu: str
    replicas: int
    meets_slo: bool
    latency_p50_s: float
    latency_p99_s: float
    completed_frac: float
    shed_frac: float
    drop_frac: float
    cost_per_1k: float                # $ per 1k completed requests
    expected_cost: float              # mean replica-hours $ per trajectory
    revocations: float
    samples: int
    token_time_s: float


def _score_cell(workload: ServingWorkload, slo: ServingSLO, *,
                replicas: int, provider: str, region: Optional[str],
                gpu: str, token_time_s: float, batch_ceiling: int,
                policy: Optional[ServingDegradationPolicy],
                resilience, horizon_s: float, samples: int,
                seed: int) -> ServingPlan:
    rset = ReplicaSet(replicas, provider, region=region, gpu=gpu,
                      seed=seed)
    sim = ServingFleetSim(rset, workload, policy=policy,
                          resilience=resilience,
                          token_time_s=token_time_s,
                          batch_ceiling=batch_ceiling,
                          horizon_s=horizon_s, seed=seed)
    results = sim.run_many(samples, engine="batched")
    n = max(workload.n_requests, 1)
    lat = np.concatenate([r.latencies_s for r in results]) \
        if results else np.empty(0)
    p50 = float(np.percentile(lat, 50)) if lat.size else math.inf
    p99 = float(np.percentile(lat, 99)) if lat.size else math.inf
    completed = float(np.mean([r.completed for r in results]))
    shed = float(np.mean([r.shed for r in results]))
    drop = float(np.mean([r.dropped_inflight for r in results]))
    cost = float(np.mean([r.cost for r in results]))
    cost_1k = cost / completed * 1000.0 if completed > 0 else math.inf
    meets = (p99 <= slo.p99_latency_s
             and shed / n <= slo.max_shed_frac
             and drop / n <= slo.max_drop_frac)
    return ServingPlan(
        provider=rset.provider.name, region=rset.region, gpu=gpu,
        replicas=replicas, meets_slo=meets,
        latency_p50_s=round(p50, 6), latency_p99_s=round(p99, 6),
        completed_frac=round(completed / n, 6),
        shed_frac=round(shed / n, 6), drop_frac=round(drop / n, 6),
        cost_per_1k=round(cost_1k, 6), expected_cost=round(cost, 6),
        revocations=round(float(np.mean([r.revocations
                                         for r in results])), 6),
        samples=samples, token_time_s=round(token_time_s, 9))


def plan_serving(workload: ServingWorkload,
                 slo: Optional[ServingSLO] = None, *,
                 replica_counts: Sequence[int] = (2, 4, 8),
                 providers: Sequence[str] = ("gcp", "aws"),
                 regions: Optional[Sequence[Optional[str]]] = None,
                 gpu: str = "v100",
                 token_time_s: float = 0.05,
                 batch_ceiling: int = 8,
                 policy: Optional[ServingDegradationPolicy] = None,
                 resilience=None,
                 horizon_s: float = 3600.0,
                 samples: int = 8,
                 seed: int = 0
                 ) -> Tuple[ServingPlan, List[ServingPlan]]:
    """Score the grid and return (best, all plans ranked best-first).

    `regions=None` scores each provider's default region (the grid stays
    small and every ensemble is a real simulation); pass explicit region
    names to widen it. Unoffered (provider, region, gpu) cells are
    skipped rather than failing the whole sweep.
    """
    slo = slo or ServingSLO()
    plans: List[ServingPlan] = []
    for prov in providers:
        for region in (regions if regions is not None else [None]):
            for n in replica_counts:
                try:
                    plans.append(_score_cell(
                        workload, slo, replicas=n, provider=prov,
                        region=region, gpu=gpu,
                        token_time_s=token_time_s,
                        batch_ceiling=batch_ceiling, policy=policy,
                        resilience=resilience, horizon_s=horizon_s,
                        samples=samples, seed=seed))
                except ValueError:
                    continue        # (region, gpu) not offered there
    if not plans:
        raise ValueError("no (replicas, provider, region) cell offers "
                         f"gpu {gpu!r}")
    plans.sort(key=lambda p: (not p.meets_slo, p.cost_per_1k,
                              p.latency_p99_s, p.replicas, p.provider,
                              p.region))
    return plans[0], plans
