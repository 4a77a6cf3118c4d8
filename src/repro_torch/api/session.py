"""`Session` — the programmatic surface of the port, for the verbs ported
so far: `describe` and `serve` (the twin of the JAX package's
`api/session.py`; plan/simulate/predict/train come with later slices).

    s = Session.from_arch("qwen3-1.7b", smoke=False)   # on the card
    out = s.serve(tokens=16)                           # gateway decode loop

A Session runs on the card unless it is built with ``device="cpu"``; with
no CUDA device and no explicit CPU request, building one raises.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.api.events import EventBus
from repro_torch.api.serving import ServeReport, generate
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api as model_api


class Session:
    """One model configuration on one device, and the ported verbs on it."""

    def __init__(self, cfg: ModelConfig, *, arch: Optional[str] = None,
                 bus: Optional[EventBus] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.arch = arch or cfg.name
        self.bus = bus or EventBus()
        self._params = None

    # ------------------------------------------------------------ creation
    @classmethod
    def from_arch(cls, arch: str, *, smoke: bool = True,
                  device: DeviceLike = None,
                  bus: Optional[EventBus] = None) -> "Session":
        """Resolve a registered architecture id (see `repro_torch.configs`);
        ids the reference serves but the port does not yet raise
        `NotImplementedError`."""
        return cls(get_config(arch, smoke=smoke), arch=arch, bus=bus,
                   device=device)

    @property
    def params(self):
        """The model's weights, drawn on first use from a generator seeded
        with 0 on the session's device."""
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
