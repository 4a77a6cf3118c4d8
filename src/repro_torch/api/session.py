"""`Session` — the programmatic surface of the port, for the verbs ported
so far: `describe`, `plan`, `plan_serving`, `predict`, `train`, `serve`,
`simulate` and `chaos` (the twin of the JAX package's `api/session.py`).

    s = Session.from_arch("qwen3-1.7b", smoke=False)   # on the card
    best, plans = s.plan(gpu="v100", score="sim", engine="jit")  # §V-C
    pred = s.predict(n_workers=4, gpu="v100")          # Eq (4)/(5)
    rep = s.train(steps=4, global_batch=2, seq_len=2048)
    rep = s.train(8, global_batch=2, seq_len=2048, members=4,
                  mode="async_ps")                     # §II async PS
    out = s.serve(tokens=16)                           # the trained weights
    ens = s.simulate(samples=65536, engine="jit")      # §VI-A fleet sim
    card = s.chaos("ps_crash", smoke=True)             # the §VI-B live loop
    best, cells = s.plan_serving()                     # the serving fleet

A Session runs on the card unless it is built with ``device="cpu"``; with
no CUDA device and no explicit CPU request, building one raises.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.api.events import EventBus
from repro_torch.api.serving import ServeReport, generate
from repro_torch.configs import RunConfig, get_config
from repro_torch.configs.base import ModelConfig, default_checkpoint_dir
from repro_torch.core.perf_model.cluster_model import (
    Eq4Inputs, PSBottleneckModel, WorkerSpec, cluster_speed,
    expected_revocations, predict_total_time)
from repro_torch.core.ps_async import async_sgd
from repro_torch.core.scheduler import LaunchPlan, plan_launch
from repro_torch.core.trainer import (MembershipEvent, TrainReport,
                                      TransientTrainer)
from repro_torch.core.transient.fleet import FleetSim, SimWorker
from repro_torch.core.transient.replacement import ReplacementModel
from repro_torch.core.transient.startup import StartupModel
from repro_torch.data.pipeline import ShardedLoader, source_for_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.compression import compression_ratio
from repro_torch.dist.elastic import Member
from repro_torch.models import api as model_api
from repro_torch.providers import FleetProvider, get_provider

# Sequential-checkpoint write bandwidth assumed when no measurement is
# available yet (§IV: T_c scales ~linearly with checkpoint size).
_CKPT_BYTES_PER_S = 200e6
_CKPT_BASE_S = 0.25


@dataclasses.dataclass
class PredictionReport:
    """Composed §III/§IV/§V predictions for one (model, cluster) pairing."""
    arch: str
    gpu: str
    region: str
    provider: str
    n_workers: int
    model_gflops: float
    model_bytes: float
    worker_speed: float          # steps/s solo (§III predictor)
    cluster_speed: float         # steps/s, PS-capped (Fig 4)
    ps_bottlenecked: bool
    ps_capacity: float           # PS ceiling, compression-scaled (§VI-B)
    grad_compression: str        # wire scheme the capacity model assumed
    payload_bytes: float         # per-push update size under that scheme
    checkpoint_seconds: float    # T_c (§IV)
    provision_seconds: float     # T_p (§V-B)
    replacement_seconds: float   # T_s (Fig 10)
    expected_revocations: float  # Eq (5)
    total_time_seconds: float    # Eq (4)


class Session:
    """One model + run configuration on one device, and the ported verbs
    on it."""

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 *, arch: Optional[str] = None,
                 bus: Optional[EventBus] = None, device: DeviceLike = None,
                 provider: object = "gcp"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run = run or RunConfig()
        self.arch = arch or cfg.name
        self.bus = bus or EventBus()
        # session-default transient market; simulate takes a per-call
        # `provider=` override (name or FleetProvider instance)
        self.provider: FleetProvider = get_provider(provider)
        self.trainer: Optional[TransientTrainer] = None
        self.last_report: Optional[TrainReport] = None
        self._params = None
        self._gens = None           # the §III generators, via the store
        self._n_tensors = None      # lazily counted parameter-tree leaves
        self._models = None         # lazily built calibration ModelStore

    # ------------------------------------------------------------ creation
    @classmethod
    def from_arch(cls, arch: str, *, smoke: bool = True,
                  run: Optional[RunConfig] = None,
                  device: DeviceLike = None,
                  bus: Optional[EventBus] = None,
                  provider: object = "gcp",
                  **run_overrides) -> "Session":
        """Resolve a registered architecture id (see `repro_torch.configs`;
        an unknown id raises `KeyError`). `run_overrides` are `RunConfig`
        fields; `provider` sets the session's default transient market."""
        run = run or RunConfig()
        if run_overrides:
            run = dataclasses.replace(run, **run_overrides)
        return cls(get_config(arch, smoke=smoke), run, arch=arch, bus=bus,
                   device=device, provider=provider)

    @property
    def params(self):
        """The model's weights: those of the last `train()`, else drawn on
        first use from a generator seeded with 0 on the session's device."""
        if self._params is None:
            self._params, _ = model_api.init(self.cfg, device=self.device)
        return self._params

    # ---------------------------------------------------------- model meta
    def describe(self) -> Dict[str, object]:
        cfg = self.cfg
        return {
            "arch": self.arch, "family": cfg.family,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "device": str(self.device),
        }

    def model_gflops(self, seq_len: Optional[int] = None,
                     per_worker_batch: int = 8) -> float:
        """C_m for the §III predictors: forward GFLOPs per worker step."""
        seq = seq_len or 64
        return self.cfg.flops_per_token(seq) * seq * per_worker_batch / 1e9

    def model_bytes(self) -> float:
        """Checkpoint/update payload (fp32 params)."""
        return 4.0 * self.cfg.param_count()

    def n_tensors(self) -> int:
        """Variable count of the parameter tree — the per-tensor RPC term
        of the PS capacity law (Table III), which compression does NOT
        shrink. Counted from a draw under `FakeTensorMode`, which builds
        the tree's shapes and allocates no weights."""
        if self._n_tensors is None:
            from torch._subclasses.fake_tensor import FakeTensorMode

            from repro_torch.tree import flatten
            with FakeTensorMode():
                values, _ = model_api.init(self.cfg, torch.Generator())
                self._n_tensors = sum(1 for _ in flatten(values))
        return self._n_tensors

    # ------------------------------------------------------ §III speed
    @property
    def models(self):
        """The session's calibration `ModelStore`: every predictor
        resolves through this one handle. Seeded from the static paper
        calibrations (the memoized `calibrate_generators()` instances) and
        updated in place by the `Recalibrator` when
        `train(recalibration=...)` is armed."""
        if self._models is None:
            from repro_torch.calibration import ModelStore
            self._models = ModelStore.with_static_calibrations()
        return self._models

    def _generators(self):
        if self._gens is None:
            store = self.models
            self._gens = {name.split("/", 1)[1]: store.current(name)
                          for name in store.names()
                          if name.startswith("step_time/")}
        return self._gens

    def _provider(self, provider: Optional[object]) -> FleetProvider:
        """Resolve a per-call override against the session default."""
        return self.provider if provider is None else get_provider(provider)

    def _check_fleet(self, gpu: str, region: Optional[str] = None,
                     provider: Optional[FleetProvider] = None) -> None:
        """The speed models only cover the measured GPUs, and each provider
        only sells certain (region, gpu) cells — fail with the options."""
        gens = self._generators()
        if gpu not in gens:
            raise ValueError(f"no calibrated speed model for {gpu!r}; "
                             f"available: {sorted(gens)}")
        prov = provider or self.provider
        if region is None:
            prov.check_gpu_offered(gpu)
        else:
            prov.check_offered(region, gpu)

    def predict_worker_speed(self, gpu: str = "v100",
                             seq_len: Optional[int] = None,
                             per_worker_batch: int = 8,
                             provider: Optional[object] = None) -> float:
        """Solo steps/s on `gpu` from the calibrated §III step-time model.

        The speed model is hardware-only; `provider` only scopes the
        does-this-market-sell-this-GPU validation."""
        self._check_fleet(gpu, provider=self._provider(provider))
        c_m = self.model_gflops(seq_len, per_worker_batch)
        return 1.0 / self._generators()[gpu].step_time(c_m)

    def checkpoint_seconds(self) -> float:
        """T_c estimate (§IV linear law) until a measured value exists."""
        if self.trainer is not None and self.trainer.ckpt.last_save_seconds:
            return self.trainer.ckpt.last_save_seconds
        return _CKPT_BASE_S + self.model_bytes() / _CKPT_BYTES_PER_S

    # ------------------------------------------------------ §V-C planner
    def plan(self, gpu: str = "v100", n_workers: int = 4,
             steps: Optional[int] = None,
             checkpoint_interval: Optional[int] = None,
             t_c: Optional[float] = None,
             hours: Optional[List[int]] = None,
             region: Optional[str] = None,
             seed: int = 0,
             provider: Optional[object] = None,
             samples: int = 200,
             n_ps: Optional[int] = None,
             score: str = "eq4",
             engine: str = "batched",
             resilience: Optional[object] = None
             ) -> Tuple[LaunchPlan, List[LaunchPlan]]:
        """Revocation-aware (region, launch-hour) planning for this model.

        `region=None` scores every region offering `gpu`; pass a region to
        constrain the plan to it. `provider` picks the transient market
        (default: the session's, normally "gcp"). `samples` sets the
        Monte-Carlo draws per (region, hour) cell — every returned
        `LaunchPlan` carries the binomial `revocation_stderr` of its
        E[revocations] estimate. `n_ps` (optional) additionally caps the
        cluster speed with the Fig 4 PS capacity model for this model's
        payload under `run.grad_compression` — the §VI-B recalibration,
        so a compressed plan sees the raised ceiling.

        `score="sim"` replaces the Eq (4) point estimate with a full
        fleet-simulation ensemble per cell (`samples` trajectories on
        `engine` — "batched", "event", or "jit", the last on the session's
        device, the card unless it was built with ``device="cpu"``), so
        every plan also carries realized time/cost percentiles and the
        `finished` censoring count — simulation-backed planning instead of
        the closed form alone.
        A sim-scored sweep ALWAYS simulates under the Fig 4 PS capacity
        for this model (defaulting to one PS when `n_ps` is not given),
        matching what `simulate()`/`predict()` would report for the
        chosen cell; the eq4 score keeps its historic uncapped Σ sp_i
        composition unless `n_ps` is passed.

        `resilience` (default: the session `run.resilience`) is honored
        under score="sim": the simulated cells price in quorum pauses and
        restore-retry stalls.
        """
        prov = self._provider(provider)
        # validate (gpu, region) BEFORE the MC sweep so a typo'd region
        # fails immediately instead of after seconds of discarded work
        self._check_fleet(gpu, region, prov)
        ps = None
        if n_ps is not None or score == "sim":
            ps = PSBottleneckModel(self.model_bytes(),
                                   1 if n_ps is None else n_ps,
                                   n_tensors=self.n_tensors(),
                                   compression=self.run.grad_compression)
        best, plans = plan_launch(
            gpu, n_workers, self.predict_worker_speed(gpu, provider=prov),
            n_w=self.run.total_steps if steps is None else steps,
            i_c=(self.run.checkpoint_interval if checkpoint_interval is None
                 else checkpoint_interval),
            t_c=t_c if t_c is not None else self.checkpoint_seconds(),
            hours=hours, seed=seed, provider=prov, samples=samples,
            # the session's real model complexity, so plan() and predict()
            # agree on the Fig 10 replacement term for the same cell
            model_gflops=self.model_gflops(), ps=ps,
            score=score, engine=engine, model_bytes=self.model_bytes(),
            # constrain BEFORE scoring: under score="sim" every discarded
            # cell would have cost a full ensemble
            region=region,
            resilience=(self.run.resilience if resilience is None
                        else resilience),
            device=self.device)
        return best, plans

    def plan_serving(self, *,
                     replica_counts=(2, 4, 8),
                     providers=("gcp", "aws"),
                     regions=None,
                     gpu: str = "v100",
                     workload=None,
                     slo=None,
                     batch_ceiling: int = 8,
                     policy=None,
                     resilience: Optional[object] = None,
                     samples: int = 8,
                     horizon_s: float = 3600.0,
                     seed: int = 0):
        """SLO-aware serving fleet planning (docs/serving.md).

        The serving sibling of `plan()`: scores every (replica_count,
        provider, region) cell with a full `ServingFleetSim` ensemble —
        revocations from each market's lifetime law, drain/handover under
        the session's resilience config — and ranks meets-SLO-first, then
        cheapest $/1k completed requests. The per-token decode time comes
        from this session's calibrated §III step-time model for `gpu`, so
        the plan prices this model's decode speed, not a constant. The
        fleet simulator is host NumPy on every device.
        """
        from repro_torch.serving import (ServingSLO, ServingWorkload,
                                         plan_serving)
        workload = workload or ServingWorkload()
        slo = slo or ServingSLO()
        # decode-round seconds on `gpu`: one token across the batch costs
        # one model step at the serving batch's complexity
        token_time_s = 1.0 / self.predict_worker_speed(
            gpu, seq_len=workload.prompt_tokens + workload.max_tokens,
            per_worker_batch=batch_ceiling)
        res = self.run.resilience if resilience is None else resilience
        best, plans = plan_serving(
            workload, slo, replica_counts=replica_counts,
            providers=providers, regions=regions, gpu=gpu,
            token_time_s=token_time_s, batch_ceiling=batch_ceiling,
            policy=policy, resilience=res, horizon_s=horizon_s,
            samples=samples, seed=seed)
        self.bus.emit("plan_serving", gpu=gpu, cells=len(plans),
                      best_provider=best.provider,
                      best_replicas=best.replicas,
                      best_meets_slo=best.meets_slo,
                      best_cost_per_1k=best.cost_per_1k)
        return best, plans

    # ------------------------------------------------ Eq (4)/(5) predict
    def predict(self, n_workers: int = 4, gpu: str = "v100",
                region: Optional[str] = None,
                steps: Optional[int] = None,
                checkpoint_interval: Optional[int] = None,
                n_ps: int = 1, t_c: Optional[float] = None,
                seed: int = 0,
                provider: Optional[object] = None) -> PredictionReport:
        """Compose the §III speed, §IV checkpoint and §V revocation models
        into the Eq (4) end-to-end wall-clock prediction. `provider` picks
        the transient market; `region=None` uses its default region."""
        prov = self._provider(provider)
        region = region or prov.default_region
        self._check_fleet(gpu, region, prov)
        n_w = self.run.total_steps if steps is None else steps
        i_c = (self.run.checkpoint_interval if checkpoint_interval is None
               else checkpoint_interval)
        worker_speed = self.predict_worker_speed(gpu, provider=prov)
        # the capacity ceiling reflects the run's wire scheme (§VI-B): a
        # compressed payload raises the network term by 1/compression_ratio
        # while the per-tensor RPC term stays — RPC-bound models (many
        # small tensors) keep their ceiling
        ps = PSBottleneckModel(self.model_bytes(), n_ps,
                               n_tensors=self.n_tensors(),
                               compression=self.run.grad_compression)
        workers = [WorkerSpec(gpu, worker_speed)] * n_workers
        sp = cluster_speed(workers, ps)
        hours = n_w / sp / 3600.0
        lifetime = prov.lifetime_model(region, gpu)
        horizon = min(hours, prov.max_lifetime_hours)
        probs = [lifetime.prob_revoked_within(horizon)] * n_workers
        t_c = t_c if t_c is not None else self.checkpoint_seconds()
        if i_c == 0:  # no checkpointing: zero pauses, Eq (4) stays defined
            i_c, t_c = n_w, 0.0
        t_p = StartupModel(seed, prov).mean_total(gpu)
        t_s = ReplacementModel(seed, prov).cold_start_s(self.model_gflops())
        total = predict_total_time(sp, Eq4Inputs(n_w, i_c, t_c, t_p, t_s,
                                                 probs))
        return PredictionReport(
            arch=self.arch, gpu=gpu, region=region, provider=prov.name,
            n_workers=n_workers,
            model_gflops=self.model_gflops(),
            model_bytes=self.model_bytes(), worker_speed=worker_speed,
            cluster_speed=sp, ps_bottlenecked=ps.is_bottlenecked(workers),
            ps_capacity=ps.capacity_steps_per_s(),
            grad_compression=self.run.grad_compression,
            payload_bytes=self.model_bytes()
            * compression_ratio(self.run.grad_compression),
            checkpoint_seconds=t_c, provision_seconds=t_p,
            replacement_seconds=t_s,
            expected_revocations=expected_revocations(probs),
            total_time_seconds=total)

    # ----------------------------------------------------- elastic train
    def train(self, steps: Optional[int] = None, *, global_batch: int = 8,
              seq_len: int = 64,
              members: int = 1,
              events: Optional[List[MembershipEvent]] = None,
              holder: str = "worker-0",
              checkpoint_dir: Optional[str] = None,
              predicted_speed: Optional[float] = None,
              check_every: int = 10,
              resume: bool = True,
              mode: str = "sync",
              ps_model: Optional[PSBottleneckModel] = None,
              workers: Optional[List[WorkerSpec]] = None,
              clock=None,
              resilience: Optional[object] = None,
              recalibration: Optional[object] = None,
              worker_step_times: Optional[List[float]] = None
              ) -> TrainReport:
        """Run the transient-aware elastic trainer on the session's device;
        its events stream onto `self.bus` (``step``, ``epoch``,
        ``checkpoint``, ``checkpoint_failed``, ``restore``,
        ``lease_handover``, ``detection``, ``mitigation``, ``retry``,
        ``degradation``, ``model_drift``, ``model_refit``, ...).

        `resume=True` restores from `checkpoint_dir` when a checkpoint
        exists (lease permitting), which is how a replacement chief
        continues a run (pass a new `holder`). The default directory is the
        reference's name under TMPDIR, namespaced by arch.
        `predicted_speed` arms the bottleneck `Controller` (a check every
        `check_every` steps); `ps_model`/`workers` arm the §VI-B mitigation
        loop: the Controller attributes deviations to PS saturation and the
        trainer acts mid-run (compression, then top-k, then a PS) and
        re-derives its prediction. `clock` (a zero-arg callable returning
        seconds) replaces the profiler's wall clock — the chaos harness
        injects virtual time so detection latency is deterministic.
        `resilience` (a `repro_torch.resilience.ResilienceConfig`; default:
        the session's `run.resilience`) arms retried checkpoint saves,
        restores and joins, checksum fallback and quorum degradation.
        `recalibration` (a `repro_torch.calibration.RecalibrationConfig`;
        default: the session's `run.recalibration`) arms CUSUM drift
        detection over Controller deviations and the online refit of the
        `cluster_speed` estimator, versioned in `self.models`.
        `mode="async_ps"` runs the §II asynchronous-PS emulation
        (`core/ps_async.py`) over the same model and data, from fresh
        weights, paced by `worker_step_times` (default ``0.1 * (1 + i)``
        for each of `members` workers): an `async_step` event per applied
        update and a final `staleness` event (the staleness histogram,
        per-worker paces and realized update counts) land on the bus.
        """
        if mode == "async_ps":
            # the §II emulation has no checkpointing, membership events or
            # controller loop — reject sync-only arguments loudly rather
            # than silently dropping e.g. a checkpoint_dir the caller is
            # relying on
            unsupported = {"events": events, "checkpoint_dir": checkpoint_dir,
                           "predicted_speed": predicted_speed,
                           "ps_model": ps_model, "workers": workers,
                           "resilience": resilience,
                           "recalibration": recalibration}
            bad = sorted(k for k, v in unsupported.items() if v)
            if bad:
                raise ValueError(
                    f"mode='async_ps' does not support: {', '.join(bad)} "
                    "(no checkpointing/controller loop in the emulation)")
            return self._train_async_ps(
                steps, global_batch=global_batch, seq_len=seq_len,
                members=members, worker_step_times=worker_step_times)
        if mode != "sync":
            raise ValueError(f"unknown train mode {mode!r}; "
                             f"known: ('sync', 'async_ps')")
        if worker_step_times:
            raise ValueError("worker_step_times applies to "
                             "mode='async_ps' only (sync pacing is "
                             "measured, not configured)")
        steps = self.run.total_steps if steps is None else steps
        run = self.run
        if checkpoint_dir is not None:
            run = dataclasses.replace(run, checkpoint_dir=checkpoint_dir)
        elif run.checkpoint_dir == default_checkpoint_dir():
            # default path: keep resume-across-invocations but namespace by
            # arch so different models never restore each other's trees
            run = dataclasses.replace(
                run, checkpoint_dir=os.path.join(run.checkpoint_dir,
                                                 self.arch))
        loader = ShardedLoader(source_for_config(self.cfg, seq_len,
                                                 seed=run.seed), global_batch)
        recal_cfg = (run.recalibration if recalibration is None
                     else recalibration)
        recalibrator = None
        if recal_cfg is not None:
            from repro_torch.calibration import Recalibrator
            recalibrator = Recalibrator(config=recal_cfg, store=self.models)
            if getattr(recal_cfg, "trace_path", None):
                recalibrator.ingest_trace()
        trainer = TransientTrainer(
            self.cfg, run, loader,
            members=[Member(i) for i in range(members)], holder=holder,
            predicted_speed=predicted_speed,
            on_event=lambda kind, payload: self.bus.emit(kind, **payload),
            ps_model=ps_model, workers=workers, clock=clock,
            resilience=(run.resilience if resilience is None
                        else resilience),
            recalibrator=recalibrator, device=self.device)
        self.trainer = trainer
        state, _ = (trainer.restore_or_init() if resume
                    else (trainer.init_state(), 0))
        state, report = trainer.run_steps(state, steps, events=events,
                                          check_every=check_every)
        # serve() serves the exact final weights (the checkpoint may lag)
        self._params = state.params
        self.last_report = report
        return report

    def _train_async_ps(self, steps: Optional[int], *, global_batch: int,
                        seq_len: int, members: int,
                        worker_step_times: Optional[List[float]]
                        ) -> TrainReport:
        """§II async-PS emulation as a Session mode.

        Workers push gradients computed at stale parameter snapshots; pace
        differences produce the staleness the paper studies. The weights
        are drawn afresh by `model_api.init` on the session's device, as
        the reference draws them. Events: `async_step` per applied update,
        then one `staleness` event with the histogram, per-worker paces
        and realized update counts.
        """
        steps = self.run.total_steps if steps is None else steps
        loader = ShardedLoader(source_for_config(self.cfg, seq_len,
                                                 seed=self.run.seed),
                               global_batch)
        params, _ = model_api.init(self.cfg, device=self.device)
        # default pace spread mirrors the paper's K80-vs-V100 heterogeneity
        paces = worker_step_times or [0.1 * (1 + i) for i in range(members)]

        def loss_fn(p, batch):
            return model_api.loss_fn(p, self.cfg, batch)

        def data(worker, gen):
            # the reference ignores its key here too; each call advances
            # the loader, so the loss logged after an update is taken on
            # the next batch, as in the reference
            return ({k: torch.from_numpy(v).to(self.device)
                     for k, v in loader.next_global(1).items()},)

        t0 = time.monotonic()
        final_params, trace = async_sgd(
            loss_fn, params, data, paces, lr=self.run.lr,
            total_updates=steps, seed=self.run.seed,
            on_update=lambda info: self.bus.emit("async_step", **info))
        # serve() after an async train must see the trained weights, just
        # like the sync path
        self._params = final_params
        self.bus.emit("staleness",
                      hist=dict(sorted(trace.staleness_hist.items())),
                      worker_updates=trace.worker_updates,
                      worker_step_time=trace.worker_step_time,
                      mode="async_ps")
        report = TrainReport(
            steps_run=trace.applied_updates,
            final_loss=trace.losses[-1] if trace.losses else float("nan"),
            losses=trace.losses, speed=None, epochs=1, checkpoints=0,
            restores=0, detections=[],
            wall_seconds=time.monotonic() - t0)
        self.last_report = report
        return report

    # ---------------------------------------------------- chaos scenarios
    def chaos(self, scenario: str = "all", *, engine: str = "batched",
              live: bool = True, samples: int = 32, seed: int = 0,
              smoke: bool = False) -> Dict[str, object]:
        """Run scripted fault scenarios against this model and score the
        detection/mitigation loop against the recorded ground truth.

        `scenario` is a registered scenario name (see
        `repro_torch.chaos.list_scenarios()`) or ``"all"``. Each scenario
        runs as a fleet-simulation ensemble (`samples` faulted + baseline
        trajectories on `engine` — "batched", "event" or "jit", the last on
        the session's device — plus an engine-vs-event parity probe);
        scenarios with a live plan also drive the real `TransientTrainer`
        on the session's device under a virtual clock (`live=False` skips
        that). `smoke=True` also checks each scenario's `expect` gates and
        sets the scorecard's `passed` flag.

        Returns the JSON-serializable scorecard `python -m repro_torch
        chaos` prints.
        """
        from repro_torch.chaos import runner as chaos_runner
        return chaos_runner.run_scenarios(
            scenario, session=self, engine=engine, live=live,
            samples=samples, seed=seed, smoke=smoke)

    # ------------------------------------------------------------- serve
    def serve(self, tokens: int = 16, *, batch: int = 4,
              prompt_len: int = 32, temperature: float = 0.0,
              seed: int = 1, prompt=None) -> ServeReport:
        report = generate(self.cfg, self.params, batch=batch,
                          prompt_len=prompt_len, tokens=tokens,
                          temperature=temperature, seed=seed, prompt=prompt,
                          device=self.device)
        self.bus.emit("serve", arch=report.arch, batch=report.batch,
                      tokens=report.tokens_generated,
                      tokens_per_second=round(report.tokens_per_second, 3),
                      decode_ms_p50=round(report.decode_ms_p50, 4),
                      decode_ms_p95=round(report.decode_ms_p95, 4),
                      decode_ms_p99=round(report.decode_ms_p99, 4),
                      device=report.device)
        return report

    # ------------------------------------------------- §VI-A fleet sim
    def simulate(self, n_workers: int = 4, gpu: str = "v100",
                 region: Optional[str] = None,
                 counts: Optional[Dict[str, int]] = None,
                 steps: Optional[int] = None,
                 checkpoint_interval: Optional[int] = None,
                 n_ps: int = 1, seed: int = 0, replace: bool = True,
                 handover: bool = True,
                 max_hours: float = 48.0,
                 provider: Optional[object] = None,
                 start_hour: float = 0.0,
                 samples: int = 1,
                 engine: str = "batched",
                 chaos: object = None,
                 resilience: Optional[object] = None):
        """Discrete-event simulation on a transient cluster.

        Either a homogeneous (`n_workers` x `gpu`) cluster or an explicit
        heterogeneous `counts` mapping gpu -> count. `provider` picks the
        transient market; `region=None` uses that market's default region;
        `start_hour` is the local launch hour (diurnal lifetime laws).

        `samples=1` runs one trajectory (the event loop) and returns a
        `SimResult`. `samples>1` runs a `FleetSim.run_many` ensemble and
        returns a `FleetEnsemble` whose `.stats` is the p50/p90/mean
        `SimStats` summary; `engine` picks the trajectory stepper —
        "batched" (default) the lockstep NumPy engine, "event" the
        per-trajectory discrete-event loop, "jit" the device engine on the
        session's device (the card unless the session was built with
        ``device="cpu"``).

        The simulated PS capacity uses this model's variable count and
        `run.grad_compression`. `chaos` (a `repro_torch.chaos.FaultTimeline`)
        scripts faults into the simulated fleet; `resilience` (a
        `repro_torch.resilience.ResilienceConfig`; default: the session's
        `run.resilience`) arms quorum degradation and restore-retry stalls
        in the simulated fleet — identically on every engine.
        """
        sim, n_steps = self._fleet_sim(
            n_workers=n_workers, gpu=gpu, region=region, counts=counts,
            steps=steps, checkpoint_interval=checkpoint_interval, n_ps=n_ps,
            seed=seed, replace=replace, handover=handover,
            provider=provider, chaos=chaos, resilience=resilience)
        if samples > 1:
            return sim.run_many(n_steps, samples, max_hours=max_hours,
                                start_hour=start_hour, engine=engine,
                                device=self.device)
        return sim.run(n_steps, max_hours=max_hours, start_hour=start_hour)

    def _fleet_sim(self, *, n_workers: int = 4, gpu: str = "v100",
                   region: Optional[str] = None,
                   counts: Optional[Dict[str, int]] = None,
                   steps: Optional[int] = None,
                   checkpoint_interval: Optional[int] = None,
                   n_ps: int = 1, seed: int = 0, replace: bool = True,
                   handover: bool = True,
                   provider: Optional[object] = None,
                   chaos: object = None,
                   resilience: Optional[object] = None
                   ) -> Tuple[FleetSim, int]:
        """Construct the configured `FleetSim` (and the resolved step
        budget) without running it — `simulate()`'s builder."""
        prov = self._provider(provider)
        region = region or prov.default_region
        counts = counts or {gpu: n_workers}
        for g in counts:
            self._check_fleet(g, region, prov)
        n_steps = self.run.total_steps if steps is None else steps
        i_c = (self.run.checkpoint_interval if checkpoint_interval is None
               else checkpoint_interval)
        t_c = self.checkpoint_seconds()
        if i_c == 0:  # no checkpointing: one interval past the run's end
            i_c, t_c = n_steps + 1, 0.0
        c_m = self.model_gflops()
        gens = self._generators()
        workers, wid = [], 0
        for g, n in counts.items():
            for _ in range(n):
                workers.append(SimWorker(wid, g, region,
                                         1.0 / gens[g].step_time(c_m)))
                wid += 1
        sim = FleetSim(
            workers, model_gflops=c_m, model_bytes=self.model_bytes(),
            step_speed_of=lambda g: 1.0 / gens[g].step_time(c_m),
            checkpoint_interval_steps=i_c, checkpoint_time_s=t_c, n_ps=n_ps,
            seed=seed, replace=replace, handover=handover,
            price_of={g: prov.price(g) for g in counts}, provider=prov,
            n_tensors=self.n_tensors(),
            grad_compression=self.run.grad_compression, chaos=chaos,
            resilience=(self.run.resilience if resilience is None
                        else resilience))
        return sim, n_steps
