"""`Session` — the programmatic surface of the port, for the verbs ported
so far: `describe`, `train` and `serve` (the twin of the JAX package's
`api/session.py`; plan/simulate/predict come with later slices).

    s = Session.from_arch("qwen3-1.7b", smoke=False)   # on the card
    rep = s.train(steps=4, global_batch=2, seq_len=2048)
    out = s.serve(tokens=16)                           # the trained weights

A Session runs on the card unless it is built with ``device="cpu"``; with
no CUDA device and no explicit CPU request, building one raises.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from repro_torch.api.events import EventBus
from repro_torch.api.serving import ServeReport, generate
from repro_torch.configs import RunConfig, get_config
from repro_torch.configs.base import ModelConfig, default_checkpoint_dir
from repro_torch.core.trainer import (MembershipEvent, TrainReport,
                                      TransientTrainer)
from repro_torch.data.pipeline import ShardedLoader, SyntheticTokenSource
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.elastic import Member
from repro_torch.models import api as model_api


class Session:
    """One model + run configuration on one device, and the ported verbs
    on it."""

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 *, arch: Optional[str] = None,
                 bus: Optional[EventBus] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run = run or RunConfig()
        self.arch = arch or cfg.name
        self.bus = bus or EventBus()
        self.trainer: Optional[TransientTrainer] = None
        self.last_report: Optional[TrainReport] = None
        self._params = None

    # ------------------------------------------------------------ creation
    @classmethod
    def from_arch(cls, arch: str, *, smoke: bool = True,
                  run: Optional[RunConfig] = None,
                  device: DeviceLike = None,
                  bus: Optional[EventBus] = None,
                  **run_overrides) -> "Session":
        """Resolve a registered architecture id (see `repro_torch.configs`);
        ids the reference serves but the port does not yet raise
        `NotImplementedError`. `run_overrides` are `RunConfig` fields."""
        run = run or RunConfig()
        if run_overrides:
            run = dataclasses.replace(run, **run_overrides)
        return cls(get_config(arch, smoke=smoke), run, arch=arch, bus=bus,
                   device=device)

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
              ps_model: Optional[object] = None,
              workers: Optional[List[object]] = None,
              resilience: Optional[object] = None,
              recalibration: Optional[object] = None) -> TrainReport:
        """Run the transient-aware elastic trainer on the session's device;
        its events stream onto `self.bus` (``step``, ``epoch``,
        ``checkpoint``, ``checkpoint_failed``, ``restore``,
        ``lease_handover``).

        `resume=True` restores from `checkpoint_dir` when a checkpoint
        exists (lease permitting), which is how a replacement chief
        continues a run (pass a new `holder`). The default directory is the
        reference's name under TMPDIR, namespaced by arch. `mode="async_ps"` and the §VI-B /
        resilience / recalibration arguments are not ported yet and raise
        `NotImplementedError`.
        """
        if mode == "async_ps":
            raise NotImplementedError(
                "mode='async_ps' (the §II asynchronous-PS emulation) is not "
                "ported to repro_torch yet (ROADMAP.md, queue 1 item 11)")
        if mode != "sync":
            raise ValueError(f"unknown train mode {mode!r}; "
                             f"known: ('sync', 'async_ps')")
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
        loader = ShardedLoader(SyntheticTokenSource(
            self.cfg.vocab_size, seq_len, seed=run.seed), global_batch)
        trainer = TransientTrainer(
            self.cfg, run, loader,
            members=[Member(i) for i in range(members)], holder=holder,
            predicted_speed=predicted_speed,
            on_event=lambda kind, payload: self.bus.emit(kind, **payload),
            ps_model=ps_model, workers=workers, resilience=resilience,
            recalibrator=recalibration, device=self.device)
        self.trainer = trainer
        state, _ = (trainer.restore_or_init() if resume
                    else (trainer.init_state(), 0))
        state, report = trainer.run_steps(state, steps, events=events,
                                          check_every=check_every)
        # serve() serves the exact final weights (the checkpoint may lag)
        self._params = state.params
        self.last_report = report
        return report

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
