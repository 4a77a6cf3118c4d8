"""Fig 2 — training-speed stability: REAL wall-clock training of a small CNN
on this host; coefficient of variation of windowed speeds should be small
post-warmup (paper: <= 0.02 on GPUs; CPU jitter is higher but bounded).

The port's twin of `benchmarks/fig2_stability.py`: the same CNN, SGD and
profiler on the device (the card unless ``device="cpu"``), each step
waited for before it is recorded. With ``warmup_seconds=0.5`` the speed
reads 0.0 when the steps after the first take under 0.5 s together: the
card needs more than the default 30 steps for a reading.
"""
from __future__ import annotations

import torch

from repro_torch.bench._common import sync
from repro_torch.core.profiler import PerformanceProfiler
from repro_torch.data.pipeline import CIFARLikeSource
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn
from repro_torch.tree import flatten

SPEC = cnn.CNNSpec("bench_tiny", "resnet", 1, 8)
LR = 0.05


def sgd_step(params, spec: cnn.CNNSpec, images, labels,
             lr: float = LR) -> torch.Tensor:
    """One plain SGD step on ``params`` in place (leaves that require
    grad); returns the loss before the update, as the reference's jitted
    ``train_step`` does."""
    leaves = [t for _, t in flatten(params)]
    loss = cnn.loss_fn(params, spec, images, labels)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        torch._foreach_add_(leaves, grads, alpha=-lr)
    return loss.detach()


def run(steps: int = 30, batch: int = 16, device: DeviceLike = None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = cnn.init_params(gen, SPEC)
    for _, t in flatten(params):
        t.requires_grad_()
    src = CIFARLikeSource()

    prof = PerformanceProfiler(window=5, warmup_steps=5, warmup_seconds=0.5)
    for s in range(steps):
        b = src.batch(s, 0, 1, batch)
        sgd_step(params, SPEC, torch.as_tensor(b["images"], device=dev),
                 torch.as_tensor(b["labels"], device=dev))
        sync(dev)
        prof.record(s)
    cov = prof.cov()
    return [{"name": f"fig2/real_{dev.type}_speed_steps_per_s",
             "value": round(prof.speed() or 0.0, 3),
             "derived": f"cov={cov if cov is not None else -1:.4f} "
                        f"(paper GPUs <=0.02; CPU jitter tolerated <0.5)"}]


if __name__ == "__main__":
    for r in run():
        print(r)
