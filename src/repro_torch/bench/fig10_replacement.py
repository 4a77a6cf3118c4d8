"""Fig 10 — worker replacement overhead, cold vs warm.

Two parts: (a) the calibrated model for the paper's four CNNs; (b) a REAL
measurement of a cold start against a warm one with the params resident.

The port's twin of `benchmarks/fig10_replacement.py`. Part (b) runs on the
device (the card unless ``device="cpu"``): cold = draw the params there
and make the first loss call (on the card its first convolutions set up
cuDNN); warm exec = a second call; warm restart = a freshly built closure
over the resident params. The port compiles nothing, so a warm restart
re-traces nothing: it is one more call.
"""
from __future__ import annotations

import time

import torch

from repro_torch.bench._common import sync
from repro_torch.core.perf_model.speed_model import TABLE1_MODELS
from repro_torch.core.transient.replacement import ReplacementModel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn


def run(device: DeviceLike = None):
    dev = resolve_device(device)
    out = []
    m = ReplacementModel(seed=0)
    for model, c_m in TABLE1_MODELS.items():
        out.append({"name": f"fig10/model/{model}/cold",
                    "value": round(m.cold_start_s(c_m), 1),
                    "derived": f"warm={m.warm_start_s(c_m):.1f}s"})
    # real measurement (small CNN so it fits in benchmark time)
    spec = cnn.RESNET_15
    imgs = torch.zeros((8, 32, 32, 3), device=dev)
    labels = torch.zeros((8,), dtype=torch.int32, device=dev)

    t0 = time.monotonic()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = cnn.init_params(gen, spec)

    def step(p):
        return cnn.loss_fn(p, spec, imgs, labels)
    step(params)
    sync(dev)
    cold = time.monotonic() - t0

    t0 = time.monotonic()
    step(params)  # warm: resident params, set-up done
    sync(dev)
    warm_exec = time.monotonic() - t0
    t0 = time.monotonic()

    def step2(p):
        return cnn.loss_fn(p, spec, imgs, labels)
    step2(params)  # warm restart: a new closure, nothing to re-trace
    sync(dev)
    warm = time.monotonic() - t0

    out.append({"name": "fig10/real/resnet15_cold_s",
                "value": round(cold, 3),
                "derived": f"warm_restart={warm:.3f}s exec={warm_exec*1e3:.1f}ms "
                           f"cold>warm={int(cold > warm)}"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
