"""Features of the paper's §III models: model complexity C_m (FLOPs per
step), GPU computational capacity C_gpu (peak TFLOP/s), computation ratio
C_norm = C_m / C_gpu, min-max normalized. The port's copy of the JAX
package's `core/perf_model/features.py`.

`GPU_SPECS` is the reference's table (the v5e row is a TPU chip, kept so
the table is the reference's). It has no row for the H100 on purpose: a
caller that models the card passes its peak itself
(`calibration.transfer_step_time_model(..., target_teraflops=)`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str
    teraflops: float          # paper's C_gpu
    mem_gb: float
    hourly_price: float       # on-demand $/h (approx. GCP 2019)
    transient_price: float    # preemptible $/h


# The paper's three GPUs (§III-A) + TPU v5e chip for the TPU-native path.
GPU_SPECS: Dict[str, GPUSpec] = {
    "k80": GPUSpec("k80", 4.11, 12.0, 0.45, 0.135),
    "p100": GPUSpec("p100", 9.53, 16.0, 1.46, 0.43),
    "v100": GPUSpec("v100", 14.13, 16.0, 2.48, 0.74),
    "v5e": GPUSpec("v5e", 197.0, 16.0, 1.2, 0.36),  # bf16 chip
}


def c_norm(c_m: np.ndarray, c_gpu: np.ndarray) -> np.ndarray:
    """Computation ratio: model complexity / GPU capacity."""
    return np.asarray(c_m, float) / np.asarray(c_gpu, float)


def minmax_fit(x: np.ndarray) -> Tuple[float, float]:
    x = np.asarray(x, float)
    return float(x.min()), float(x.max())


def minmax_apply(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    span = (hi - lo) if hi > lo else 1.0
    return (np.asarray(x, float) - lo) / span
