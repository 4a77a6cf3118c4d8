"""The GPU table of the paper's §III models — the port's copy of the JAX
package's `core/perf_model/features.py`, cut to `GPU_SPECS`, which the GCP
adapter's price sheet reads (`providers/gcp.py`).

C_gpu is the peak TFLOP/s of each GPU (the v5e row is a TPU chip, kept so
the table is the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


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
