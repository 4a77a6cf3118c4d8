"""Named, seeded, composable chaos scenarios (docs/chaos.md).

A `Scenario` scripts faults against a small transient fleet and records
the ground truth the evaluator scores against. The *sim* side is a tuple
of `injectors` primitives compiled into a `FaultTimeline`; scenarios that
also carry a `LivePlan` drive the real `TransientTrainer` through the
same fault kinds via `TransientTrainer.inject_fault` under a virtual
clock, so the Controller's detect -> attribute -> mitigate loop (§VI-B)
is exercised for real, not just simulated.

Register new scenarios with the `@register_scenario` decorator::

    @register_scenario
    def my_outage() -> Scenario:
        return Scenario(name="my_outage", faults=(PSCrash(1.0, 0.5, 0.1),),
                        description="...")

`expect` holds the smoke gates `python -m repro chaos --smoke` enforces;
see `runner._check_expectations` for the supported keys.

The port's copy of the JAX package's `chaos/scenarios.py`, with every
scenario of the reference: the fleet scenarios, the `recorded_trace`
replay, the `serve_wave` serving fleet and the live plans, which drive
the port's trainer through `runner._run_live`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.chaos.injectors import (CheckpointOutage, FaultTimeline,
                                         PSCrash, PreemptionWave,
                                         PriceSpike, StragglerFault)


@dataclasses.dataclass(frozen=True)
class LiveFault:
    """One `TransientTrainer.inject_fault` call, scheduled at a step."""
    step: int
    kind: str                       # ps_crash/ps_recover/ckpt_outage/...
    payload: Mapping = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class LivePlan:
    """How a scenario drives the live trainer.

    The harness sizes a synthetic PS-bound cluster: `n_workers` workers
    of `worker_speed` steps/s each, against one PS whose *healthy*
    capacity is `ps_capacity_over_demand` x the aggregate worker demand
    (values < 1 reproduce the paper's §VI-B saturated-PS regime, which
    is what lets the controller attribute a measured slowdown to the PS
    and walk the compression ladder). Faults in `faults` fire at their
    step boundaries; paired start/end kinds define the ground-truth
    spans `truth()` returns (an unpaired start runs to `n_steps`).
    """
    n_steps: int
    faults: Tuple[LiveFault, ...]
    check_every: int = 5
    checkpoint_interval: int = 0
    n_workers: int = 4
    worker_speed: float = 25.0
    ps_capacity_over_demand: float = 2.0

    _ENDS = {"ps_crash": "ps_recover", "ckpt_outage": "ckpt_recover",
             "straggler": "straggler_end"}

    def truth(self) -> List[dict]:
        """Ground-truth spans in *steps*: [{kind, start_step, end_step}]."""
        spans: List[dict] = []
        open_spans: Dict[tuple, dict] = {}
        for f in sorted(self.faults, key=lambda f: f.step):
            if f.kind in self._ENDS:
                key = (f.kind, f.payload.get("slot"))
                span = {"kind": f.kind, "start_step": f.step,
                        "end_step": self.n_steps, **dict(f.payload)}
                spans.append(span)
                open_spans[key] = span
            else:
                for start, end in self._ENDS.items():
                    if f.kind == end:
                        key = (start, f.payload.get("slot"))
                        if key in open_spans:
                            open_spans.pop(key)["end_step"] = f.step
        return spans


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named fault script plus the fleet it runs against."""
    name: str
    description: str
    faults: Tuple = ()                  # injectors primitives (sim side)
    provider: str = "gcp"
    region: Optional[str] = None        # None = provider default region
    gpu: str = "v100"
    n_workers: int = 4
    total_steps: int = 300_000
    max_hours: float = 48.0
    handover: bool = True
    live: Optional[LivePlan] = None
    #: a `repro_torch.serving.ServingScript`: the scenario scripts faults over
    #: a serving ReplicaSet instead of a training fleet (docs/serving.md)
    serving: Optional[object] = None
    expect: Mapping = dataclasses.field(default_factory=dict)

    def timeline(self, roster, seed: int = 0) -> FaultTimeline:
        """Compile the fault script against a launch roster. The seed is
        the *scenario* seed: both engines must hand `FaultTimeline` the
        same value or their hazard draws diverge."""
        return FaultTimeline(self.faults, roster, seed=seed)


_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(fn: Callable[[], Scenario]) -> Callable[[], Scenario]:
    """Decorator: evaluate `fn` once and file its `Scenario` by name."""
    sc = fn()
    if sc.name in _REGISTRY:
        raise ValueError(f"scenario {sc.name!r} already registered")
    _REGISTRY[sc.name] = sc
    return fn


def get_scenario(name: str) -> Scenario:
    if name not in _REGISTRY:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------- built-ins
@register_scenario
def regional_wave() -> Scenario:
    """Correlated preemption wave through one region (§V: revocations are
    not independent when the provider reclaims a zone's capacity)."""
    return Scenario(
        name="regional_wave",
        description="GCP reclaims us-central1 capacity for one hour: "
                    "+6/h revocation hazard on every worker in the region",
        faults=(PreemptionWave(0.5, 1.0, 6.0, region="us-central1"),),
        provider="gcp", region="us-central1",
        expect={"min_extra_revocations": 1.0, "min_extra_time_s": 60.0,
                # armed runs (--quorum 0.75): the wave must push the fleet
                # below quorum long enough to register real pause time
                "resilient_min_paused_s": 60.0})


@register_scenario
def price_spike() -> Scenario:
    """Provider-wide spot-price rise through the fleet's bid (the AWS
    price-signal hazard regime, market-wide rather than zonal)."""
    return Scenario(
        name="price_spike",
        description="AWS spot price rises through the bid for 4 h: "
                    "+2/h hazard on the whole fleet",
        faults=(PriceSpike(0.25, 4.0, 2.0),),
        provider="aws", region="us-east-1",
        expect={"min_extra_revocations": 1.0})


@register_scenario
def dead_ps() -> Scenario:
    """Hard PS crash: capacity 0 for an hour — training fully stalls, and
    the run must resume when the window ends (the engines' sp=0 +
    pending-boundary path)."""
    return Scenario(
        name="dead_ps",
        description="parameter server hard-down for 1 h mid-run",
        faults=(PSCrash(0.5, 1.0, 0.0),),
        expect={"min_extra_time_s": 3000.0, "max_extra_revocations": 20.0})


@register_scenario
def ps_crash() -> Scenario:
    """Throttled PS. The live plan starts PS-bound (healthy capacity =
    0.2x demand, the §VI-B regime) and silently cuts PS bandwidth to
    10 %: the controller must notice from measurement alone and walk the
    full compression ladder (none -> int8 -> topk), at which point the
    50x payload shrink restores full worker-bound speed."""
    return Scenario(
        name="ps_crash",
        description="PS capacity quietly drops to 25 % (sim) / 10 % (live)",
        faults=(PSCrash(0.5, 2.0, 0.25),),
        live=LivePlan(
            n_steps=60, check_every=5,
            ps_capacity_over_demand=0.2,
            faults=(LiveFault(20, "ps_crash", {"capacity_factor": 0.1}),)),
        expect={"min_extra_time_s": 60.0,
                "live_detected_all": True,
                "live_max_latency_steps": 10,
                "live_actions": ["enable_compression", "enable_compression"],
                "live_final_compression": "topk",
                "live_max_false_alarms": 0})


@register_scenario
def straggler() -> Scenario:
    """Degraded-NIC worker: one roster slot silently runs at 30 % speed.
    Live, the cluster is worker-bound, so the right attribution is a
    worker replacement — not a PS mitigation."""
    return Scenario(
        name="straggler",
        description="slot 1 silently throttled to 30 % for 3 h (sim) / "
                    "40 steps (live)",
        faults=(StragglerFault(0.5, 3.0, slot=1, speed_factor=0.3),),
        live=LivePlan(
            n_steps=80, check_every=5,
            faults=(LiveFault(25, "straggler",
                              {"slot": 1, "speed_factor": 0.3}),
                    LiveFault(65, "straggler_end", {"slot": 1}))),
        expect={"min_extra_time_s": 60.0,
                "live_detected_all": True,
                "live_max_latency_steps": 10,
                "live_actions": [],        # no PS lever fits a straggler
                "live_max_wrong_actions": 0,
                "live_max_false_alarms": 0,
                # armed runs (--recalibrate): no lever fits a straggler the
                # cluster keeps, so the *model* must adapt — CUSUM confirms
                # the drift, the refit relearns the degraded speed from
                # profiler history, and the next check lands back inside
                # the controller's 6.7 % threshold
                "recalib_min_drift_events": 1,
                "recalib_min_refits": 1,
                "recalib_max_post_refit_deviation": 0.067})


@register_scenario
def ckpt_outage() -> Scenario:
    """Checkpoint-store outage: saves fail fast, so a post-window stock
    revocation rolls back to a checkpoint from before the outage."""
    return Scenario(
        name="ckpt_outage",
        description="checkpoint store down for 2 h (sim) / 25 steps "
                    "(live, saves every 5 steps fail fast)",
        faults=(CheckpointOutage(0.25, 2.0),),
        handover=False,                 # stock chief: lost steps visible
        live=LivePlan(
            n_steps=60, check_every=5, checkpoint_interval=5,
            faults=(LiveFault(20, "ckpt_outage"),
                    LiveFault(45, "ckpt_recover"))),
        expect={"live_min_ckpt_failures": 3,
                "live_max_false_alarms": 0,
                # armed runs (--retry-attempts 4): saves inside the outage
                # must be retried, at least one must recover on a later
                # attempt, and the post-run corruption drill must restore
                # from the previous valid generation (no torn-state loads)
                "resilient_live_min_retries": 5,
                "resilient_live_min_recovered_saves": 1,
                "resilient_drill_ok": True})


@register_scenario
def recorded_trace() -> Scenario:
    """Replay of a *recorded* eviction/price trace (docs/calibration.md
    §traces): the bundled sample afternoon — an eviction cluster riding a
    spot-price excursion in us-central1 — compiled into standard hazard
    primitives by `TraceInjector`, so the replay inherits keyed draws,
    engine parity and the smoke gates. The trace is the port's own copy,
    read beside this module."""
    import os

    from repro_torch.chaos.trace_injector import TraceInjector

    inj = TraceInjector.from_file(
        os.path.join(os.path.dirname(__file__), "data",
                     "sample_trace.jsonl"),
        n_workers=4, bid=0.10)
    return Scenario(
        name="recorded_trace",
        description="replay of the bundled us-central1 afternoon trace: "
                    "a 1 h eviction cluster (~3/h empirical hazard) inside "
                    "a 1 h price excursion over the $0.10 bid",
        faults=inj.faults(),
        provider="gcp", region="us-central1",
        expect={"min_extra_revocations": 1.0, "min_extra_time_s": 60.0})


@register_scenario
def serve_wave() -> Scenario:
    """Preemption wave over a *serving* ReplicaSet (docs/serving.md): a
    4-replica continuous-batching fleet on AWS (2-minute revocation
    warnings) takes a minutes-scale wave through an open-loop request
    stream. The runner scores an armed-vs-stock delta: armed, warned
    replicas drain and hand unfinished requests to survivors (zero
    in-flight drops — the headline gate) while admission control bounds
    the p99 inflation; stock drops whatever the wave catches in-flight."""
    from repro_torch.serving import (ServingDegradationPolicy, ServingScript,
                                     ServingWorkload)

    return Scenario(
        name="serve_wave",
        description="AWS us-east-1 serving fleet: +60/h revocation hazard "
                    "for 3 min through a 400-request stream at 2 req/s",
        faults=(PreemptionWave(0.01, 0.05, 60.0),),
        provider="aws", region="us-east-1",
        serving=ServingScript(
            replicas=4, batch_ceiling=8, token_time_s=0.05,
            horizon_s=1800.0,
            workload=ServingWorkload(
                n_requests=400, arrival_rate_per_s=2.0, prompt_tokens=32,
                min_tokens=8, max_tokens=32, high_priority_frac=0.25,
                queue_capacity=64, queue_budget_s=15.0,
                hedge_timeout_s=20.0),
            policy=ServingDegradationPolicy(
                reduce_tokens_below=1.0, shrink_batch_below=0.75,
                shed_below=0.5)),
        expect={"serving_zero_dropped_warned": True,
                "serving_min_armed_drop_delta": 1.0,
                "serving_max_p99_inflation": 20.0,
                "serving_min_degraded_cycles": 1.0})


@register_scenario
def wave_price_combo() -> Scenario:
    """Composition: a regional wave inside a provider-wide price spike,
    with a straggler and a checkpoint outage overlapping — the
    worst-afternoon-ever script."""
    return Scenario(
        name="wave_price_combo",
        description="us-central1 wave + fleet-wide spike + straggler + "
                    "checkpoint outage, overlapping",
        faults=(PriceSpike(0.25, 3.0, 1.5),
                PreemptionWave(0.5, 1.0, 5.0, region="us-central1"),
                StragglerFault(0.5, 2.0, slot=0, speed_factor=0.5),
                CheckpointOutage(0.75, 1.0)),
        provider="gcp", region="us-central1",
        expect={"min_extra_revocations": 1.0, "min_extra_time_s": 60.0})
