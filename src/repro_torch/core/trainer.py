"""Transient-aware elastic training loop — the twin of the JAX package's
`core/trainer.py`, on the port's eager train step.

Integrates: the train step (launch/steps.py), resumable data pipeline,
lease-based checkpointing, performance profiler, bottleneck controller, and
a revocation schedule (from the fleet simulator or injected by tests).

Loop contract per step, as in the reference:
  1. drain membership events (revocations / joins) -> roll epoch, re-split
     batch, possibly steal the checkpoint-writer lease; apply the quorum
     degradation tier (resilience armed);
  2. fetch the epoch's data shards (deterministic in (seed, step, shard));
  3. train_step (`launch.steps.make_train_step`) on the trainer's device;
  4. profiler.record; controller.check on a cadence, the §VI-B mitigation
     it calls for, and the drift/refit loop (recalibration armed);
  5. checkpoint on the interval (writer-lease holder only), retried under
     the resilience policy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import CheckpointCorruptError
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.controller import Action, Controller, Detection
from repro_torch.core.perf_model.cluster_model import (PSBottleneckModel,
                                                       WorkerSpec,
                                                       cluster_speed)
from repro_torch.core.profiler import PerformanceProfiler
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.elastic import ElasticMembership, Member
from repro_torch.launch import steps as st
from repro_torch.models import api
from repro_torch.resilience import (ResilienceConfig, RetryExhausted,
                                    call_with_retries)
from repro_torch.spans import span
from repro_torch.tree import tree_map


@dataclasses.dataclass
class MembershipEvent:
    step: int
    kind: str            # revoke | join
    member_id: int
    gpu: str = "v5e"


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_loss: float
    losses: List[float]
    speed: Optional[float]
    epochs: int
    checkpoints: int
    restores: int
    detections: List[Detection]
    wall_seconds: float
    #: §VI-B mitigations applied mid-run (see `apply_mitigation` payloads)
    mitigations: List[dict] = dataclasses.field(default_factory=list)
    #: checkpoint saves that failed (chaos checkpoint-store outage)
    checkpoint_failures: int = 0
    #: chaos faults injected mid-run (see `inject_fault` payloads)
    faults: List[dict] = dataclasses.field(default_factory=list)
    #: recovery accounting (resilience enabled)
    retries: int = 0                    # backoff retries beyond attempt 1
    recovered_saves: int = 0            # saves that landed after failures
    fallback_depth: int = 0             # checkpoint generations skipped
    paused_steps: int = 0               # step slots skipped below quorum
    degradations: List[dict] = dataclasses.field(default_factory=list)
    #: online-recalibration ledgers (recalibration armed)
    drift_events: List[dict] = dataclasses.field(default_factory=list)
    refits: List[dict] = dataclasses.field(default_factory=list)
    #: the global gradient norm of each step, before clipping
    grad_norms: List[float] = dataclasses.field(default_factory=list)


class TransientTrainer:
    def __init__(self, cfg: ModelConfig, run: RunConfig, loader: ShardedLoader,
                 members: Optional[List[Member]] = None,
                 holder: str = "worker-0",
                 predicted_speed: Optional[float] = None,
                 on_event: Optional[Callable[[str, dict], None]] = None,
                 ps_model: Optional[PSBottleneckModel] = None,
                 workers: Optional[List[WorkerSpec]] = None,
                 auto_mitigate: bool = True,
                 mitigation_scheme: str = "int8",
                 max_mitigations: int = 8,
                 clock: Optional[Callable[[], float]] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 recalibrator: Optional[object] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.run = run
        self.loader = loader
        self.device = resolve_device(device)
        self._emit = on_event or (lambda kind, payload: None)
        self.members = ElasticMembership(
            members or [Member(0)], loader.global_batch)
        self.profiler = PerformanceProfiler(window=10, warmup_steps=5,
                                            warmup_seconds=0.0)
        self.controller = Controller()
        # the writer lease shares the trainer's clock, so chaos
        # VirtualClock scenarios exercise lease expiry without sleeping
        self.ckpt = Checkpointer(run.checkpoint_dir, holder=holder,
                                 clock=clock or time.time)
        self.predicted_speed = predicted_speed
        # §VI-B mitigation loop state: a PS capacity model + worker specs
        # let the controller attribute a slowdown to PS saturation and let
        # the trainer act on it mid-run (apply_mitigation)
        if ps_model is not None and ps_model.compression != run.grad_compression:
            ps_model = dataclasses.replace(ps_model,
                                           compression=run.grad_compression)
        self.ps_model = ps_model
        self.workers = workers
        self.auto_mitigate = auto_mitigate
        self.mitigation_scheme = mitigation_scheme
        # backstop against mitigation loops: adding a PS is self-limiting,
        # but a badly mis-set prediction could otherwise re-fire on every
        # check
        self.max_mitigations = max_mitigations
        # chaos hooks: an injectable profiler clock (virtual time makes
        # detection latency deterministic across machines) and live fault
        # state the chaos driver toggles via `inject_fault`
        self.clock = clock
        self.ckpt_outage = False
        self.ckpt_failures = 0
        self.faults: List[dict] = []
        self.restores = 0
        self.mitigations: List[dict] = []
        # recovery layer: None keeps the fail-fast save and strict restore
        self.resilience = resilience
        # under a virtual clock a backoff sleep must not block the host
        self._sleep: Callable[[float], None] = (
            (lambda s: None) if clock is not None else time.sleep)
        self.retries = 0
        self.recovered_saves = 0
        self.fallback_depth = 0
        self.paused_steps = 0
        self.degradations: List[dict] = []
        # online recalibration: None keeps the static prediction
        self.recalibrator = recalibrator
        if recalibrator is not None:
            recalibrator.bind(self._emit)
            if predicted_speed:
                recalibrator.seed(predicted_speed)
            self.controller.model_version = recalibrator.version
        #: the latest state of `run_steps` (a ``step`` event handler may
        #: read it; the optimizer updates its tensors in place)
        self.state: Optional[st.TrainState] = None
        self._rebuild_step()
        self.detections: List[Detection] = []

    def _rebuild_step(self) -> None:
        # eager PyTorch: a new step closure for the run's compression
        # scheme; the optimizer is stateless, so the state's AdamW moments
        # carry over to the new step unchanged
        self.train_step, self.opt = st.make_train_step(self.cfg, self.run)

    # ------------------------------------------------------------------ state
    def init_state(self) -> st.TrainState:
        params, _ = api.init(self.cfg, device=self.device)
        return st.TrainState(params, self.opt.init(params),
                             torch.zeros((), dtype=torch.int32),
                             st.init_residual(params, self.run))

    def restore_or_init(self) -> Tuple[st.TrainState, int]:
        # a mid-run ENABLE_COMPRESSION must outlive the process: the scheme
        # is run *state* recorded in the checkpoint metadata, so a restart
        # whose config says "none" resumes compressed (and keeps its
        # error-feedback residual)
        try:
            saved = self.ckpt.read_meta().get("grad_compression", "none")
        except (FileNotFoundError, ValueError):
            saved = "none"
        if saved != "none" and self.run.grad_compression == "none":
            self.run = dataclasses.replace(self.run, grad_compression=saved)
            self._rebuild_step()
            if self.ps_model is not None:
                self.ps_model = dataclasses.replace(self.ps_model,
                                                    compression=saved)
        template = self.init_state()
        try:
            try:
                state, step = self._restore_validated(template)
                residual = state.residual
            except KeyError:
                # checkpoint predates compression (no residual entries):
                # restore the legacy (params, opt, step) triple and start
                # the error-feedback residual from zero
                legacy = st.TrainState(template.params, template.opt,
                                       template.step)
                state, step = self.ckpt.restore(legacy)
                residual = tree_map(torch.zeros_like, template.residual)
            self.loader.step = step
            self.restores += 1
            self._emit("restore", {"step": step, "restores": self.restores})
            return st.TrainState(state.params, state.opt,
                                 torch.tensor(step, dtype=torch.int32),
                                 residual), step
        except FileNotFoundError:
            return template, 0
        except CheckpointCorruptError as exc:
            # every committed generation failed validation: surface it and
            # restart clean rather than load torn state
            self._emit("restore_failed", {"error": str(exc)})
            return template, 0

    def _restore_validated(self, template):
        """Restore under the resilience policy: retry the read, validate
        checksums, and fall back generation by generation past torn or
        corrupt checkpoints (``restore_fallback`` events record each skip).
        With resilience disabled this is the strict restore."""
        res = self.resilience
        if res is None:
            return self.ckpt.restore(template)

        def on_fallback(step, exc):
            self.fallback_depth += 1
            self._emit("restore_fallback", {"step": step,
                                            "depth": self.fallback_depth,
                                            "error": str(exc)})

        def attempt():
            tree, step, _depth = self.ckpt.restore_latest_valid(
                template, on_fallback=on_fallback)
            return tree, step

        try:
            (tree, step), attempts = call_with_retries(
                attempt, res.retry, op="restore", seed=self.run.seed,
                key=-1, sleep=self._sleep, emit=self._emit,
                retry_on=(CheckpointCorruptError,))
        except RetryExhausted as exc:
            self.retries += exc.attempts - 1
            raise exc.last
        self.retries += attempts - 1
        return tree, step

    # ------------------------------------------------------------------- run
    def run_steps(self, state: st.TrainState, n_steps: int,
                  events: Optional[List[MembershipEvent]] = None,
                  check_every: int = 10) -> Tuple[st.TrainState, TrainReport]:
        events = sorted(events or [], key=lambda e: e.step)
        ev_i = 0
        losses: List[float] = []
        grad_norms: List[float] = []
        checkpoints = 0
        t0 = time.monotonic()
        start_step = int(state.step)
        steps_run = 0
        base_global_batch = self.loader.global_batch
        tier = "continue"
        for local in range(n_steps):
            step = start_step + local
            # 1. membership events at this step boundary
            while ev_i < len(events) and events[ev_i].step <= step:
                ev = events[ev_i]
                ev_i += 1
                if ev.kind == "revoke":
                    if ev.member_id not in self.members:
                        continue  # stale schedule entry: member already gone
                    epoch = self.members.revoke(ev.member_id)
                    # revoked writer: lease handover (Fig 11 fix)
                    if not self.ckpt.lease.held_by_me():
                        self.ckpt.lease.notify_revoked()
                        if self.ckpt.lease.try_acquire():
                            self._emit("lease_handover",
                                       {"step": step,
                                        "holder": self.ckpt.lease.holder,
                                        "revoked_member": ev.member_id})
                else:
                    if ev.member_id in self.members:
                        continue  # stale join (already present)
                    epoch = self._join_member(ev)
                self._emit("epoch", {"step": step, "kind": ev.kind,
                                     "member_id": ev.member_id,
                                     "epoch": epoch.number,
                                     "n_alive": len(epoch.members)})
                if not epoch.members:
                    raise RuntimeError("all members revoked")
            # 1b. quorum degradation tier: pause skips this step slot
            # entirely (future joins can restore quorum), shrink scales the
            # global batch down for the time being
            new_tier = ("continue" if self.resilience is None else
                        self.resilience.degradation.tier(
                            self.members.n_alive, self.members.roster_size))
            if new_tier != tier:
                tier = new_tier
                record = {"step": step, "tier": tier,
                          "n_alive": self.members.n_alive,
                          "roster_size": self.members.roster_size}
                self.degradations.append(record)
                self._emit("degradation", record)
            if tier == "pause":
                self.paused_steps += 1
                if ev_i >= len(events):
                    break  # no future join can restore quorum
                continue
            if tier == "shrink_batch":
                self.loader.global_batch = max(
                    self.members.n_alive,
                    int(round(base_global_batch
                              * self.resilience.degradation.shrink_factor)))
            else:
                self.loader.global_batch = base_global_batch
            # 2. data (global batch stays constant across membership changes)
            n_shards = max(1, self.members.n_alive)
            with span("trainer.batch"):
                shards = self.loader.next_global(n_shards)
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in shards.items()}
            # 3. step
            state, metrics = self.train_step(state, batch)
            self.state = state
            steps_run += 1
            loss = float(metrics["loss"])
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            payload: Dict[str, object] = {"step": step, "loss": loss}
            if "payload_bytes" in metrics:
                # §VI-B telemetry: the compressed wire size of this push
                payload["payload_bytes"] = float(metrics["payload_bytes"])
                payload["grad_compression"] = self.run.grad_compression
            self._emit("step", payload)
            # 4. profile + detect (+ §VI-B mitigation). With an injected
            # clock (chaos), the "step" emit above let the driver advance
            # virtual time for this step before it is recorded.
            self.profiler.record(
                step, t=self.clock() if self.clock is not None else None,
                loss=loss)
            if self.predicted_speed and step % check_every == 0 and step > 0:
                state = self._check(state, step)
            # 5. checkpoint
            if self.run.checkpoint_interval and \
                    (step + 1) % self.run.checkpoint_interval == 0:
                checkpoints += self._save_checkpoint(step + 1, state)
        self.loader.global_batch = base_global_batch
        report = TrainReport(
            steps_run=steps_run,
            final_loss=losses[-1] if losses else float("nan"),
            losses=losses, speed=self.profiler.speed(),
            epochs=self.members.epoch_no + 1, checkpoints=checkpoints,
            restores=self.restores, detections=self.detections,
            wall_seconds=time.monotonic() - t0,
            mitigations=self.mitigations,
            checkpoint_failures=self.ckpt_failures, faults=self.faults,
            retries=self.retries, recovered_saves=self.recovered_saves,
            fallback_depth=self.fallback_depth,
            paused_steps=self.paused_steps, degradations=self.degradations,
            drift_events=(list(self.recalibrator.drift_events)
                          if self.recalibrator is not None else []),
            refits=(list(self.recalibrator.refits)
                    if self.recalibrator is not None else []),
            grad_norms=grad_norms)
        return state, report

    def _check(self, state: st.TrainState, step: int) -> st.TrainState:
        """One controller check, the mitigation it calls for, and the
        drift/refit loop's observation of it."""
        det = self.controller.check(self.profiler, self.predicted_speed,
                                    ps_model=self.ps_model,
                                    workers=self.workers)
        self.detections.append(det)
        self._emit("detection", {"step": step,
                                 "bottleneck": det.bottleneck,
                                 "action": det.action.value,
                                 "deviation": det.deviation,
                                 "model_version": det.model_version})
        mitigated = False
        if self.auto_mitigate and det.action in (
                Action.ADD_PARAMETER_SERVER, Action.ENABLE_COMPRESSION) \
                and len(self.mitigations) < self.max_mitigations:
            state = self.apply_mitigation(det.action, state, step=step)
            self.state = state
            mitigated = True
        if self.recalibrator is not None:
            if mitigated:
                # mitigation changed the cluster; deviation against the
                # pre-mitigation prediction is void drift input
                self.recalibrator.notify_mitigation(step)
            else:
                dev = det.deviation if det.measured is not None else None
                new_speed = self.recalibrator.observe(step, dev,
                                                      self.profiler)
                if new_speed is not None:
                    self._apply_refit(new_speed, step)
        return state

    def _join_member(self, ev: MembershipEvent):
        """Replacement join, retried under the resilience policy: a join
        that races a membership epoch roll is transient, so it gets the
        same bounded backoff as a checkpoint save."""
        join = lambda: self.members.join(Member(ev.member_id, ev.gpu))
        if self.resilience is None:
            return join()
        epoch, attempts = call_with_retries(
            join, self.resilience.retry, op="join", seed=self.run.seed,
            key=ev.member_id, sleep=self._sleep, emit=self._emit,
            retry_on=(RuntimeError,))
        self.retries += attempts - 1
        return epoch

    def _save_checkpoint(self, step: int, state) -> int:
        """One interval save. Without resilience an outage fails fast and
        drops the save. With it, the save is retried under the policy
        (``retry`` events per attempt); only once attempts/deadline are
        exhausted does it count as a ``checkpoint_failed``, and that event
        carries the attempt count. Returns 1 if a checkpoint committed."""
        metadata = {**self.loader.state(),
                    "grad_compression": self.run.grad_compression}
        if self.resilience is None:
            if self.ckpt_outage:
                # chaos checkpoint-store outage: the save fails fast and
                # the run continues on its last good checkpoint
                self.ckpt_failures += 1
                self._emit("checkpoint_failed",
                           {"step": step, "failures": self.ckpt_failures})
                return 0
            sizes = self.ckpt.save(step, state, metadata=metadata)
            if sizes is None:
                return 0
            self._emit("checkpoint", {"step": step, "sizes": sizes})
            return 1

        def attempt():
            if self.ckpt_outage:
                raise OSError("checkpoint store unavailable (ckpt_outage)")
            return self.ckpt.save(step, state, metadata=metadata)

        had_failures = self.ckpt_failures > 0
        try:
            sizes, attempts = call_with_retries(
                attempt, self.resilience.retry, op="checkpoint_save",
                seed=self.run.seed, key=step, sleep=self._sleep,
                emit=self._emit)
        except RetryExhausted as exc:
            self.retries += exc.attempts - 1
            self.ckpt_failures += 1
            self._emit("checkpoint_failed",
                       {"step": step, "failures": self.ckpt_failures,
                        "attempts": exc.attempts,
                        "error": type(exc.last).__name__})
            return 0
        self.retries += attempts - 1
        if sizes is None:
            return 0
        if attempts > 1 or had_failures:
            self.recovered_saves += 1
        self._emit("checkpoint", {"step": step, "sizes": sizes})
        return 1

    # ------------------------------------------------------------- refit
    def _apply_refit(self, new_speed: float, step: int) -> None:
        """Adopt a drift-triggered refit: the controller now compares
        against the refit prediction (and stamps its new version), and the
        measurement window restarts so the next check is refit-vs-post-
        drift data, not refit-vs-straddled history."""
        self.predicted_speed = new_speed
        self.controller.model_version = self.recalibrator.version
        self.profiler.records.clear()
        self.profiler._win.clear()

    # ---------------------------------------------------- chaos injection
    def inject_fault(self, kind: str, step: int = 0, **payload) -> None:
        """Flip one live fault on/off mid-run (the chaos driver's hook).

        ``ckpt_outage`` / ``ckpt_recover`` fail checkpoint saves / resume
        saving: the one fault the trainer itself enacts, since it owns the
        save path. ``ps_crash`` / ``ps_recover`` and ``straggler`` /
        ``straggler_end`` are bookkeeping only, as in the reference: the
        faults are silent, so the trainer's capacity model and prediction
        stay healthy while the chaos driver's virtual clock prices every
        step at the truly degraded cluster speed.
        """
        if kind == "ckpt_outage":
            self.ckpt_outage = True
        elif kind == "ckpt_recover":
            self.ckpt_outage = False
        elif kind not in ("ps_crash", "ps_recover",
                          "straggler", "straggler_end"):
            raise ValueError(f"unknown fault kind {kind!r}")
        record = {"step": step, "fault": kind, **payload}
        self.faults.append(record)
        self._emit("fault", record)

    # ------------------------------------------------------- §VI-B mitigate
    def apply_mitigation(self, action: Action, state: st.TrainState,
                         step: int = 0) -> st.TrainState:
        """Act on a PS-bottleneck detection mid-run and re-derive the
        prediction the controller compares against.

        * ``ADD_PARAMETER_SERVER`` — provision one more PS in the capacity
          model;
        * ``ENABLE_COMPRESSION`` — walk the compression ladder one rung: an
          uncompressed run flips to ``mitigation_scheme`` (the dense
          quantizer, attaching a zero error-feedback residual on the
          params' device), a dense-compressed run escalates to ``topk``
          (keeping its residual: the trees are shaped alike). Either way
          the step is rebuilt for the new scheme and the PS capacity model
          recalibrated with ``compression_ratio``.

        Either way ``predicted_speed`` is recomputed from the new capacity
        so later `Controller.check` calls measure against the mitigated
        cluster, and a ``mitigation`` event is emitted.
        """
        if self.ps_model is None:
            return state
        if action is Action.ADD_PARAMETER_SERVER:
            self.ps_model = self.controller.mitigate_ps(self.ps_model)
        elif action is Action.ENABLE_COMPRESSION:
            current = self.run.grad_compression
            target = (self.mitigation_scheme if current == "none"
                      else "topk")
            if current != target and current != "topk":
                self.run = dataclasses.replace(
                    self.run, grad_compression=target)
                self._rebuild_step()
                if current == "none":
                    state = state._replace(
                        residual=st.init_residual(state.params, self.run))
            self.ps_model = self.controller.mitigate_compression(
                self.ps_model, self.run.grad_compression)
        else:
            return state
        if self.workers:
            self.predicted_speed = cluster_speed(self.workers, self.ps_model)
        # restart the measurement window: `speed()` averages the whole
        # post-warmup history, so pre-mitigation records would keep the
        # measured speed depressed for many steps and re-trigger the
        # controller against the already-mitigated cluster
        self.profiler.records.clear()
        self.profiler._win.clear()
        record = {"step": step, "action": action.value,
                  "n_ps": self.ps_model.n_ps,
                  "grad_compression": self.run.grad_compression,
                  "ps_capacity": self.ps_model.capacity_steps_per_s(),
                  "predicted_speed": self.predicted_speed}
        self.mitigations.append(record)
        self._emit("mitigation", record)
        return state
