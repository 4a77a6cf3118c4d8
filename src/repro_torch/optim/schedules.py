"""Learning-rate schedules (callables step -> lr) — the twin of the JAX
package's `optim/schedules.py`. Each returns a 0-d float32 tensor on the
CPU, computed in float32 as the reference computes it."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=_F32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        frac = torch.clamp((_step(step) + 1.0) / max(1, warmup_steps),
                           max=1.0)
        return torch.tensor(lr, dtype=_F32) * frac
    return fn


def cosine_warmup(lr: float, warmup_steps: int, total_steps: int,
                  min_frac: float = 0.1):
    def fn(step):
        step = _step(step)
        warm = torch.clamp((step + 1.0) / max(1, warmup_steps), max=1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.tensor(lr, dtype=_F32) * warm * cos
    return fn
