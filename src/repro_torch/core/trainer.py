"""Transient-aware elastic training loop — the twin of the JAX package's
`core/trainer.py`, on the port's eager train step.

Loop contract per step, as in the reference:
  1. drain membership events (revocations / joins) -> roll epoch, re-split
     batch, possibly steal the checkpoint-writer lease;
  2. fetch the epoch's data shards (deterministic in (seed, step, shard));
  3. train_step (`launch.steps.make_train_step`) on the trainer's device;
  4. profiler.record;
  5. checkpoint on the interval (writer-lease holder only).

Not in this slice (ROADMAP.md, queue 1 item 5): the §VI-B mitigation loop
(the bottleneck `Controller`, `cluster_model`, `apply_mitigation`), the
resilience layer and online recalibration. Passing ``predicted_speed``,
``ps_model``, ``workers``, ``resilience`` or ``recalibrator`` raises
`NotImplementedError`. With them unset the reference runs the same loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import CheckpointCorruptError
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.profiler import PerformanceProfiler
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.elastic import ElasticMembership, Member
from repro_torch.launch import steps as st
from repro_torch.models import api
from repro_torch.tree import tree_map

_NOT_PORTED = ("the §VI-B mitigation loop, resilience and recalibration are "
               "not ported to repro_torch yet (ROADMAP.md, queue 1 item 5)")


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
    wall_seconds: float
    #: checkpoint saves that failed (chaos checkpoint-store outage)
    checkpoint_failures: int = 0
    #: chaos faults injected mid-run (see `inject_fault` payloads)
    faults: List[dict] = dataclasses.field(default_factory=list)
    #: the global gradient norm of each step, before clipping
    grad_norms: List[float] = dataclasses.field(default_factory=list)


class TransientTrainer:
    def __init__(self, cfg: ModelConfig, run: RunConfig, loader: ShardedLoader,
                 members: Optional[List[Member]] = None,
                 holder: str = "worker-0",
                 predicted_speed: Optional[float] = None,
                 on_event: Optional[Callable[[str, dict], None]] = None,
                 ps_model: Optional[object] = None,
                 workers: Optional[List[object]] = None,
                 resilience: Optional[object] = None,
                 recalibrator: Optional[object] = None,
                 device: DeviceLike = None):
        unported = {"predicted_speed": predicted_speed, "ps_model": ps_model,
                    "workers": workers,
                    "resilience": resilience or run.resilience,
                    "recalibrator": recalibrator or run.recalibration}
        bad = sorted(k for k, v in unported.items() if v)
        if bad:
            raise NotImplementedError(f"{', '.join(bad)}: {_NOT_PORTED}")
        self.cfg = cfg
        self.run = run
        self.loader = loader
        self.device = resolve_device(device)
        self._emit = on_event or (lambda kind, payload: None)
        self.members = ElasticMembership(
            members or [Member(0)], loader.global_batch)
        self.profiler = PerformanceProfiler(warmup_steps=5,
                                            warmup_seconds=0.0)
        self.ckpt = Checkpointer(run.checkpoint_dir, holder=holder)
        self.ckpt_outage = False
        self.ckpt_failures = 0
        self.faults: List[dict] = []
        self.restores = 0
        #: the latest state of `run_steps` (a ``step`` event handler may
        #: read it; the optimizer updates its tensors in place)
        self.state: Optional[st.TrainState] = None
        self._rebuild_step()

    def _rebuild_step(self) -> None:
        self.train_step, self.opt = st.make_train_step(self.cfg, self.run)

    # ------------------------------------------------------------------ state
    def init_state(self) -> st.TrainState:
        params, _ = api.init(self.cfg, device=self.device)
        return st.TrainState(params, self.opt.init(params),
                             torch.zeros((), dtype=torch.int32),
                             st.init_residual(params, self.run))

    def restore_or_init(self) -> Tuple[st.TrainState, int]:
        # a compression scheme recorded in the checkpoint is run *state*:
        # a restart whose config says "none" resumes compressed (and keeps
        # its error-feedback residual)
        try:
            saved = self.ckpt.read_meta().get("grad_compression", "none")
        except (FileNotFoundError, ValueError):
            saved = "none"
        if saved != "none" and self.run.grad_compression == "none":
            self.run = dataclasses.replace(self.run, grad_compression=saved)
            self._rebuild_step()
        template = self.init_state()
        try:
            try:
                state, step = self.ckpt.restore(template)
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
            self._emit("restore_failed", {"error": str(exc)})
            return template, 0

    # ------------------------------------------------------------------- run
    def run_steps(self, state: st.TrainState, n_steps: int,
                  events: Optional[List[MembershipEvent]] = None,
                  check_every: int = 10) -> Tuple[st.TrainState, TrainReport]:
        """``check_every`` paces the bottleneck controller in the reference;
        it is accepted and unused until that loop is ported."""
        events = sorted(events or [], key=lambda e: e.step)
        ev_i = 0
        losses: List[float] = []
        grad_norms: List[float] = []
        checkpoints = 0
        t0 = time.monotonic()
        start_step = int(state.step)
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
                    epoch = self.members.join(Member(ev.member_id, ev.gpu))
                self._emit("epoch", {"step": step, "kind": ev.kind,
                                     "member_id": ev.member_id,
                                     "epoch": epoch.number,
                                     "n_alive": len(epoch.members)})
                if not epoch.members:
                    raise RuntimeError("all members revoked")
            # 2. data (global batch stays constant across membership changes)
            n_shards = max(1, self.members.n_alive)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.loader.next_global(n_shards).items()}
            # 3. step
            state, metrics = self.train_step(state, batch)
            self.state = state
            loss = float(metrics["loss"])
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            payload: Dict[str, object] = {"step": step, "loss": loss}
            if "payload_bytes" in metrics:
                # §VI-B telemetry: the compressed wire size of this push
                payload["payload_bytes"] = float(metrics["payload_bytes"])
                payload["grad_compression"] = self.run.grad_compression
            self._emit("step", payload)
            # 4. profile
            self.profiler.record(step, loss=loss)
            # 5. checkpoint
            if self.run.checkpoint_interval and \
                    (step + 1) % self.run.checkpoint_interval == 0:
                checkpoints += self._save_checkpoint(step + 1, state)
        report = TrainReport(
            steps_run=n_steps,
            final_loss=losses[-1] if losses else float("nan"),
            losses=losses, speed=self.profiler.speed(),
            epochs=self.members.epoch_no + 1, checkpoints=checkpoints,
            restores=self.restores, wall_seconds=time.monotonic() - t0,
            checkpoint_failures=self.ckpt_failures, faults=self.faults,
            grad_norms=grad_norms)
        return state, report

    def _save_checkpoint(self, step: int, state) -> int:
        """One interval save. An outage fails fast and drops the save
        (``checkpoint_failed``); the run continues on its last good
        checkpoint. Returns 1 if a checkpoint committed."""
        if self.ckpt_outage:
            self.ckpt_failures += 1
            self._emit("checkpoint_failed",
                       {"step": step, "failures": self.ckpt_failures})
            return 0
        metadata = {**self.loader.state(),
                    "grad_compression": self.run.grad_compression}
        sizes = self.ckpt.save(step, state, metadata=metadata)
        if sizes is None:
            return 0
        self._emit("checkpoint", {"step": step, "sizes": sizes})
        return 1

    # ---------------------------------------------------- chaos injection
    def inject_fault(self, kind: str, step: int = 0, **payload) -> None:
        """Flip one live fault on/off mid-run (the chaos driver's hook).

        ``ckpt_outage`` / ``ckpt_recover`` fail checkpoint saves fast /
        resume saving. ``ps_crash`` / ``ps_recover`` and ``straggler`` /
        ``straggler_end`` are bookkeeping only, as in the reference.
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
