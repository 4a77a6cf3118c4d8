"""Fig 5 + §IV-A — REAL checkpoint measurements: save all twenty CNNs with
the repo checkpointer, record (S_d, S_i, S_m) and wall-clock time.

Local disk writes are near-instant for small CNNs, so (as the paper saves to
cloud storage in-region) a calibrated remote-storage path adds modeled
upload time at GCS-like bandwidth. Both components are reported.

The port's twin of `benchmarks/fig5_checkpoint.py`. Each tree is drawn on
the device (the card unless ``device="cpu"``), so a save includes the
device-to-host copy.
"""
from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.perf_model.checkpoint_model import CkptRow
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn

REMOTE_BW = 120e6       # bytes/s sustained to in-region cloud storage
REMOTE_LATENCY = 0.35   # per-checkpoint commit latency, seconds


def measure(repeats: int = 3, remote: bool = True,
            device: DeviceLike = None):
    dev = resolve_device(device)
    rows = []
    for name, spec in cnn.ZOO.items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = cnn.init_params(gen, spec)
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d, holder="bench")
            times = []
            sizes = None
            for i in range(repeats):
                t0 = time.monotonic()
                sizes = ck.save(i, params)
                t = time.monotonic() - t0
                if remote:
                    t += REMOTE_LATENCY + sizes.total / REMOTE_BW
                times.append(t)
            rows.append(CkptRow(name, sizes.s_d, sizes.s_m, sizes.s_i,
                                float(np.mean(times))))
    return rows


def run(device: DeviceLike = None):
    rows = measure(device=device)
    out = []
    for r in rows:
        out.append({"name": f"fig5/{r.model}",
                    "value": round(r.t_c, 4),
                    "derived": f"s_c={r.s_c/1e6:.2f}MB s_d={r.s_d/1e6:.2f}MB"})
    # correlation between size and time (the paper's positive correlation)
    sc = np.array([r.s_c for r in rows])
    tc = np.array([r.t_c for r in rows])
    corr = float(np.corrcoef(sc, tc)[0, 1])
    out.append({"name": "fig5/size_time_correlation", "value": round(corr, 4),
                "derived": "pearson r"})
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
