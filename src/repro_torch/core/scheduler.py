"""Revocation-aware launch planner — the paper's §V-C future work, built:
"investigating how strategically launching transient clusters at different
times of day and different data center locations can help mitigate
revocation impacts."

For a desired (GPU, cluster size, workload), score every (region,
launch-hour) offering that GPU: Monte-Carlo the diurnal-aware lifetime model
for E[revocations] during the run, push that through Eq (4) for expected
wall-clock, and price the result (transient rates + replacement overheads).
Returns the Pareto plan (min expected cost, tie-broken by time).

The Monte-Carlo core is batched (docs/performance.md): each (region, hour)
cell is ONE `RevocationSampler.lifetimes` draw — the lifetime model is
resolved once and `samples` candidates come back as an array, then scored
through the shared Eq (4) (`predict_total_time`, so plan() and predict()
can never drift apart) with the startup/replacement means hoisted out of
the loop. Every cell also reports the binomial standard error of its
E[revocations] estimate, threaded through `Session.plan` and the `plan`
CLI.

`provider=` selects the market being planned over (DESIGN.md §5): regions,
lifetime laws, startup/replacement overheads and prices all come from the
`repro_torch.providers` adapter, so the same planner compares GCP
preemptible, AWS spot and Azure low-priority offerings.

The port's copy of the JAX package's `core/scheduler.py` (it imports
nothing of it). Under score="sim" with engine="jit" each cell's ensemble
runs on `device` (the CUDA card unless ``device="cpu"``), where every
round launches the event-select kernel; the planner never moves it to the
CPU on its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.perf_model.cluster_model import (Eq4Inputs,
                                                       PSBottleneckModel,
                                                       WorkerSpec,
                                                       cluster_speed,
                                                       predict_total_time)
from repro_torch.core.transient.replacement import ReplacementModel
from repro_torch.core.transient.revocation import RevocationSampler
from repro_torch.core.transient.startup import StartupModel


@dataclasses.dataclass
class LaunchPlan:
    region: str
    gpu: str
    launch_hour: int
    n_workers: int
    expected_revocations: float
    expected_time_s: float
    expected_cost: float
    provider: str = "gcp"
    #: standard error of `expected_revocations` (same units): binomial
    #: under score="eq4", the trajectory-sample SEM under score="sim"
    revocation_stderr: float = 0.0
    #: Monte-Carlo sample count behind the estimate
    samples: int = 0
    #: how the cell was scored: "eq4" (Eq (4) point estimate around a
    #: lifetime MC) or "sim" (full batched fleet-simulation ensemble)
    score: str = "eq4"
    #: distribution summary, populated under score="sim" (zeros otherwise)
    time_p50_s: float = 0.0
    time_p90_s: float = 0.0
    cost_p50: float = 0.0
    cost_p90: float = 0.0
    #: trajectories that completed every step (score="sim"); if it is
    #: below `samples` the cell's time/cost understate the truth
    finished: int = 0


def expected_revocations_mc(region: str, gpu: str, start_hour: float,
                            run_hours: float, n_workers: int,
                            samples: int = 200, seed: int = 0,
                            provider: object = "gcp") -> float:
    """Diurnal-aware E[revocations]: MC over the lifetime sampler (the CDF
    alone is launch-hour-agnostic). One batched draw; see the `_stats`
    variant for the standard error."""
    return expected_revocations_mc_stats(region, gpu, start_hour, run_hours,
                                         n_workers, samples, seed,
                                         provider)[0]


def expected_revocations_mc_stats(region: str, gpu: str, start_hour: float,
                                  run_hours: float, n_workers: int,
                                  samples: int = 200, seed: int = 0,
                                  provider: object = "gcp"
                                  ) -> Tuple[float, float]:
    """(E[revocations], standard error) from one batched lifetime draw."""
    if samples < 1:
        raise ValueError(f"need at least one MC sample, got {samples}")
    samp = RevocationSampler(seed, provider)
    horizon = min(run_hours, samp.provider.max_lifetime_hours)
    lts = samp.lifetimes(region, gpu, samples, start_hour)
    p_hat = _hit_fraction(lts, horizon)
    return n_workers * p_hat, _binomial_stderr(p_hat, samples, n_workers)


def _hit_fraction(lifetimes: np.ndarray, horizon_hours: float) -> float:
    """Fraction of sampled lifetimes revoked inside the horizon."""
    return float(np.count_nonzero(
        np.isfinite(lifetimes) & (lifetimes <= horizon_hours))
        / max(len(lifetimes), 1))


def _binomial_stderr(p_hat: float, samples: int, n_workers: int) -> float:
    return n_workers * math.sqrt(max(p_hat * (1.0 - p_hat), 0.0)
                                 / max(samples, 1))


def plan_launch(gpu: str, n_workers: int, worker_speed: float,
                n_w: int, i_c: int, t_c: float,
                hours: Optional[List[int]] = None,
                seed: int = 0,
                provider: object = "gcp",
                model_gflops: float = 1.54,
                samples: int = 200,
                ps: Optional[PSBottleneckModel] = None,
                score: str = "eq4",
                engine: str = "batched",
                model_bytes: float = 1.87e6,
                replace: bool = True,
                handover: bool = True,
                max_sim_hours: Optional[float] = None,
                region: Optional[str] = None,
                resilience: object = None,
                device: object = None
                ) -> Tuple[LaunchPlan, List[LaunchPlan]]:
    """Scores all (region, hour) cells of one provider; returns (best, all).

    worker_speed: steps/s per worker for the target model (from the §III
    predictors); model_gflops: its complexity C_m, which sets the Fig 10
    replacement cold-start (default: the paper's ResNet-32); samples: MC
    draws (score="eq4") or simulated trajectories (score="sim") per
    (region, hour) cell. Costing: transient hourly price x workers x
    expected time, replacement overhead included via Eq (4) — or, under
    score="sim", the ensemble's realized GPU-hour cost.

    `score` picks the estimator behind each cell:

    * ``"eq4"`` (default) — the Eq (4) point estimate around one batched
      lifetime draw (+ binomial stderr), exactly the historic planner.
    * ``"sim"`` — a full `FleetSim.run_many` ensemble per cell on
      `engine` (`"batched"`/`"event"`/`"jit"`): every plan carries
      realized time/cost percentiles (`time_p50_s`/`time_p90_s`/
      `cost_p50`/`cost_p90`), the trajectory-sample revocation stderr and
      the `finished` censoring count, so the chosen cell reflects the
      simulated dynamics (chief loss, replacement chains, diurnal join
      hours) instead of the Eq (4) closed form alone. `model_bytes`,
      `replace`, `handover` and `max_sim_hours` (default: 6x the
      no-revocation Eq (4) wall-clock, at least 48 h) shape that
      simulation; cells share the simulation seed, so they are compared
      under common random numbers like the eq4 grid.

    `ps` (optional) caps the cluster speed with the Fig 4 PS capacity
    model, including its `compression` scheme — a plan made for a
    compressed run (§VI-B) sees the raised capacity ceiling and the
    correspondingly shorter exposure window; under score="sim" the same
    recalibration is forwarded to the simulator. `ps=None` keeps the
    uncapped Σ sp_i composition.

    The eq4 MC horizon is the Eq (4) *wall-clock* — compute plus
    checkpoint pauses, then one fixed-point iteration adding the
    revocation overhead itself — not the compute-only time: a
    checkpoint-heavy run stays exposed to the market for every pause too,
    and the lifetimes are drawn once per cell so the refined horizon
    reuses the same draws.

    `region` (optional) constrains the sweep to one region BEFORE any
    cell is scored — under score="sim" every discarded cell would have
    cost a full ensemble.

    `resilience` (a `repro_torch.resilience.ResilienceConfig`) is honored
    under score="sim" only: the simulated fleets apply its quorum
    degradation and restore-retry stalls, so a plan made for a resilient
    run prices the recovery time in. The eq4 closed form has no recovery
    term and ignores it.

    `device` is read by the "jit" engine only: the device its ensembles
    run on (`FleetSim.run_many(device=)`; None is the CUDA card).
    """
    from repro_torch.providers import get_provider
    if samples < 1:
        raise ValueError(f"need at least one MC sample, got {samples}")
    if score not in ("eq4", "sim"):
        raise ValueError(f"unknown score {score!r}; known: ('eq4', 'sim')")
    prov = get_provider(provider)
    if region is not None:
        prov.check_offered(region, gpu)
        regions = [region]
    else:
        prov.check_gpu_offered(gpu)
        regions = prov.regions_offering(gpu)
    hours = hours if hours is not None else list(range(0, 24, 3))
    if i_c <= 0:  # no checkpointing: zero pauses, Eq (4) stays defined
        i_c, t_c = n_w, 0.0
    # decorrelated streams, matching FleetSim's seed+1/seed+2 convention
    # (the MC sampler itself owns `seed`)
    startup = StartupModel(seed + 1, prov)
    repl = ReplacementModel(seed + 2, prov)
    price = prov.price(gpu)
    sp = cluster_speed([WorkerSpec(gpu, worker_speed)] * n_workers, ps)
    t_p = startup.mean_total(gpu)
    t_s = repl.cold_start_s(model_gflops)

    def eq4(n_r: float) -> float:
        # spread Pr over workers equally for Eq (5)
        return predict_total_time(sp, Eq4Inputs(
            n_w, i_c, t_c, t_p, t_s, [n_r / n_workers] * n_workers))

    base_s = eq4(0.0)                       # Eq (4) without revocations
    if score == "sim":
        plans = _sim_scored_grid(
            gpu, n_workers, worker_speed, n_w, i_c, t_c, hours, seed, prov,
            model_gflops, samples, ps, engine, model_bytes, replace,
            handover,
            max_sim_hours if max_sim_hours is not None
            else max(48.0, 6.0 * base_s / 3600.0), regions, resilience,
            device)
        best = min(plans, key=lambda p: (p.expected_cost, p.expected_time_s))
        return best, plans
    horizon0 = min(base_s / 3600.0, prov.max_lifetime_hours)
    plans: List[LaunchPlan] = []
    for region in regions:
        for h in hours:
            # one batched draw per cell — same seed per cell, so cells
            # are compared under common random numbers (as the pre-
            # batched planner did by re-seeding per cell)
            samp = RevocationSampler(seed, prov)
            lts = samp.lifetimes(region, gpu, samples, float(h))
            p0 = _hit_fraction(lts, horizon0)
            # one Eq (4) iteration: revocation overhead extends exposure,
            # re-scored against the same draws
            horizon1 = min(eq4(n_workers * p0) / 3600.0,
                           prov.max_lifetime_hours)
            p1 = _hit_fraction(lts, horizon1)
            n_r = n_workers * p1
            t = eq4(n_r)
            cost = (t / 3600.0) * n_workers * price \
                + n_r * (t_p / 3600.0) * price
            plans.append(LaunchPlan(
                region, gpu, h, n_workers, n_r, t, cost, prov.name,
                revocation_stderr=_binomial_stderr(p1, samples, n_workers),
                samples=samples))
    best = min(plans, key=lambda p: (p.expected_cost, p.expected_time_s))
    return best, plans


def _sim_scored_grid(gpu, n_workers, worker_speed, n_w, i_c, t_c, hours,
                     seed, prov, model_gflops, samples, ps, engine,
                     model_bytes, replace, handover, max_sim_hours,
                     regions, resilience=None, device=None
                     ) -> List[LaunchPlan]:
    """One batched fleet-simulation ensemble per (region, hour) cell —
    the simulation-backed §V-C planner the lockstep engine makes routine
    (10k+ trajectories per sweep stay sub-second)."""
    from repro_torch.core.transient.fleet import FleetSim, SimWorker
    plans: List[LaunchPlan] = []
    for region in regions:
        for h in hours:
            workers = [SimWorker(i, gpu, region, worker_speed)
                       for i in range(n_workers)]
            sim = FleetSim(
                workers, model_gflops=model_gflops,
                model_bytes=ps.model_bytes if ps is not None
                else model_bytes,
                step_speed_of=lambda g: worker_speed,
                checkpoint_interval_steps=i_c, checkpoint_time_s=t_c,
                n_ps=ps.n_ps if ps is not None else 1,
                n_tensors=ps.n_tensors if ps is not None else 0,
                grad_compression=ps.compression if ps is not None
                else "none",
                seed=seed, replace=replace, handover=handover,
                price_of={gpu: prov.price(gpu)}, provider=prov,
                resilience=resilience)
            ens = sim.run_many(n_w, samples, max_hours=max_sim_hours,
                               start_hour=float(h), engine=engine,
                               device=device)
            st = ens.stats
            plans.append(LaunchPlan(
                region, gpu, h, n_workers,
                expected_revocations=st.revocations_mean,
                expected_time_s=st.time_mean_s,
                expected_cost=st.cost_mean,
                provider=prov.name,
                revocation_stderr=st.revocations_stderr,
                samples=samples, score="sim",
                time_p50_s=st.time_p50_s, time_p90_s=st.time_p90_s,
                cost_p50=st.cost_p50, cost_p90=st.cost_p90,
                finished=st.finished))
    return plans
