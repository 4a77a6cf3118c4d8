"""§III-C/D + §VI-A — cluster-level composition and end-to-end prediction:
the port's copy of the JAX package's `core/perf_model/cluster_model.py`
(it imports nothing of it).

Key empirical laws reproduced from the paper:
  * worker speed is invariant to cluster size/heterogeneity until the
    parameter server saturates (Table III);
  * cluster speed sp = Σ_i sp_i, capped by PS capacity (Fig 4, Fig 12);
  * total time Eq (4):
        T = N_w/sp + ceil(N_w/I_c) * T_c + N_r * (T_p + T_s)
  * expected revocations Eq (5): N_r = Σ_i Pr(R_i).

Serving one update costs max(network, RPC/apply) time —
    service = max(2*model_bytes/ps_bw, rpc_per_tensor * n_tensors) / n_ps
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.dist.compression import compression_ratio

PS_NET_BYTES_PER_S = 1.25e9   # 10 Gbps GCP NIC per parameter server
PS_RPC_PER_TENSOR_S = 2.52e-4  # per-variable RPC+apply cost, calibrated so
# ResNet-32 (97 tensors) saturates one PS at ~41 updates/s (Table III)


@dataclasses.dataclass
class WorkerSpec:
    gpu: str
    speed: float                # steps/s for the target model (solo)


@dataclasses.dataclass
class PSBottleneckModel:
    model_bytes: float
    n_ps: int = 1
    ps_bw: float = PS_NET_BYTES_PER_S
    n_tensors: int = 0
    rpc_per_tensor: float = PS_RPC_PER_TENSOR_S
    #: gradient-compression scheme on the wire (§VI-B): shrinks the network
    #: term by `compression_ratio` but NOT the per-tensor RPC term — a
    #: compressed push still issues one RPC per variable
    compression: str = "none"

    def service_time_s(self) -> float:
        net = (2.0 * self.model_bytes * compression_ratio(self.compression)
               / self.ps_bw)
        rpc = self.rpc_per_tensor * self.n_tensors
        return max(net, rpc) / self.n_ps

    def capacity_steps_per_s(self) -> float:
        return 1.0 / self.service_time_s()

    def cluster_speed(self, workers: Sequence[WorkerSpec]) -> float:
        raw = sum(w.speed for w in workers)
        return min(raw, self.capacity_steps_per_s())

    def worker_step_time(self, workers: Sequence[WorkerSpec],
                         gpu: str) -> float:
        """Average step time of a worker of `gpu` type inside the cluster
        (Table III): slowed uniformly once the PS saturates."""
        raw = sum(w.speed for w in workers)
        cap = self.capacity_steps_per_s()
        slowdown = max(1.0, raw / cap)
        solo = next(w.speed for w in workers if w.gpu == gpu)
        return slowdown / solo

    def is_bottlenecked(self, workers: Sequence[WorkerSpec]) -> bool:
        return sum(w.speed for w in workers) > self.capacity_steps_per_s()

    # Estimator protocol (repro_torch.calibration) ------------------------
    @classmethod
    def fit(cls, rows: Sequence[dict], model_bytes: float,
            n_ps: int = 1, n_tensors: int = 0,
            compression: str = "none") -> "PSBottleneckModel":
        """Calibrate the PS bandwidth from observed saturated-cluster
        updates/s (rows: {capacity_steps_per_s}); the RPC term keeps its
        Table III calibration (it needs per-tensor timing we don't
        observe in aggregate)."""
        caps = [float(r["capacity_steps_per_s"]) for r in rows
                if float(r.get("capacity_steps_per_s", 0.0)) > 0]
        if not caps:
            raise ValueError("PSBottleneckModel.fit: no positive observed "
                             "capacities")
        cap = float(np.median(caps))
        # invert service = max(net, rpc)/n_ps for ps_bw; only valid when
        # the network term dominates (otherwise capacity pins down rpc)
        ratio = compression_ratio(compression)
        ps_bw = 2.0 * model_bytes * ratio * cap / n_ps
        return cls(model_bytes=model_bytes, n_ps=n_ps, ps_bw=ps_bw,
                   n_tensors=n_tensors, compression=compression)

    def predict(self, workers: Sequence[WorkerSpec]) -> float:
        return self.cluster_speed(workers)

    def update(self, rows: Sequence[dict]) -> "PSBottleneckModel":
        return type(self).fit(rows, self.model_bytes, n_ps=self.n_ps,
                              n_tensors=self.n_tensors,
                              compression=self.compression)

    def score(self, rows: Sequence[dict]) -> Dict[str, float]:
        from repro_torch.calibration.estimator import score_predictions
        caps = [float(r["capacity_steps_per_s"]) for r in rows]
        return score_predictions(caps,
                                 [self.capacity_steps_per_s()] * len(caps))

    def params_hash(self) -> str:
        from repro_torch.calibration.estimator import params_hash
        return params_hash("ps_capacity", self.model_bytes, self.n_ps,
                           self.ps_bw, self.n_tensors, self.rpc_per_tensor,
                           self.compression)


def cluster_speed(workers: Sequence[WorkerSpec],
                  ps: Optional[PSBottleneckModel] = None) -> float:
    """sp = Σ sp_i (§VI-A), PS-capped when a PS model is provided."""
    if ps is None:
        return sum(w.speed for w in workers)
    return ps.cluster_speed(workers)


@dataclasses.dataclass
class Eq4Inputs:
    n_w: int                 # training work, steps
    i_c: int                 # checkpoint interval, steps
    t_c: float               # checkpoint seconds (predicted §IV)
    t_p: float               # provisioning seconds (startup model §V-B)
    t_s: float               # worker replacement seconds (Fig 10)
    revoke_probs: Sequence[float]  # Pr(R_i) per worker over the run (Eq 5)


def expected_revocations(revoke_probs: Sequence[float]) -> float:
    """Eq (5)."""
    return float(sum(revoke_probs))


def predict_total_time(sp: float, inp: Eq4Inputs) -> float:
    """Eq (4)."""
    n_r = expected_revocations(inp.revoke_probs)
    return (inp.n_w / sp
            + math.ceil(inp.n_w / inp.i_c) * inp.t_c
            + n_r * (inp.t_p + inp.t_s))


@dataclasses.dataclass
class HeterogeneousPredictor:
    """§VI-A use case: compose per-GPU speed predictors into cluster
    predictions; built offline, refreshed from monitoring."""
    speed_of: Dict[str, float]      # gpu -> predicted steps/s (solo)
    model_bytes: float
    n_ps: int = 1
    n_tensors: int = 0
    compression: str = "none"

    def predict(self, counts: Dict[str, int]) -> float:
        workers = [WorkerSpec(g, self.speed_of[g])
                   for g, n in counts.items() for _ in range(n)]
        ps = PSBottleneckModel(self.model_bytes, self.n_ps,
                               n_tensors=self.n_tensors,
                               compression=self.compression)
        return cluster_speed(workers, ps)
