"""CM-DARE controller (Fig 1, §VI-B): compares model-predicted speed against
online measurement; deviations beyond the threshold flag a bottleneck and
trigger mitigation (add a parameter server / replace a slow worker /
re-provision after revocations).

Defaults follow the paper: 30 s warmup, 6.7 % deviation threshold.

The port's copy of the JAX package's `core/controller.py`, over the port's
`cluster_model` and profiler.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from repro_torch.core.perf_model.cluster_model import (PSBottleneckModel,
                                                       WorkerSpec)
from repro_torch.core.profiler import PerformanceProfiler


class Action(enum.Enum):
    NONE = "none"
    ADD_PARAMETER_SERVER = "add_parameter_server"
    ENABLE_COMPRESSION = "enable_compression"
    REPLACE_WORKER = "replace_worker"
    REQUEST_REPLACEMENT = "request_replacement"


@dataclasses.dataclass
class Detection:
    bottleneck: bool
    measured: Optional[float]
    predicted: float
    deviation: float
    action: Action
    note: str = ""
    #: version of the `cluster_speed` estimator the check compared against
    #: (0 = static prediction, no recalibration armed). Lets post-hoc
    #: analysis tell "deviation against the stale model" from "deviation
    #: against the refit one".
    model_version: int = 0


class Controller:
    def __init__(self, threshold: float = 0.067, warmup_seconds: float = 30.0):
        self.threshold = threshold
        self.warmup_seconds = warmup_seconds
        self.log: List[Detection] = []
        #: bumped by the recalibration loop on every refit; stamped into
        #: each Detection so the log is auditable against the ModelStore
        self.model_version = 0

    def check(self, profiler: PerformanceProfiler,
              predicted_speed: float,
              ps_model: Optional[PSBottleneckModel] = None,
              workers: Optional[List[WorkerSpec]] = None) -> Detection:
        measured = profiler.speed()
        if measured is None or predicted_speed <= 0:
            det = Detection(False, measured, predicted_speed, 0.0, Action.NONE,
                            "insufficient data / warming up",
                            model_version=self.model_version)
            self.log.append(det)
            return det
        dev = (predicted_speed - measured) / predicted_speed
        if dev <= self.threshold:
            det = Detection(False, measured, predicted_speed, dev, Action.NONE,
                            model_version=self.model_version)
            self.log.append(det)
            return det
        # bottleneck: attribute it
        action = Action.REPLACE_WORKER
        note = "under-performing worker(s) suspected"
        if ps_model is not None and workers is not None:
            if ps_model.is_bottlenecked(workers):
                over = (f"({sum(w.speed for w in workers):.2f} > "
                        f"{ps_model.capacity_steps_per_s():.2f} steps/s)")
                if ps_model.compression == "none":
                    # §VI-B: shrinking the payload is free (no new server);
                    # try it before provisioning more PS capacity
                    action = Action.ENABLE_COMPRESSION
                    note = ("aggregate worker speed exceeds PS capacity "
                            f"{over}; compress the update payload")
                elif ps_model.compression != "topk":
                    # dense compression was not enough — escalate to top-k
                    # sparsification (the last free lever) before paying
                    # for another server
                    action = Action.ENABLE_COMPRESSION
                    note = ("aggregate worker speed exceeds PS capacity "
                            f"{over} despite {ps_model.compression} "
                            "compression; escalate to top-k sparsification")
                else:
                    action = Action.ADD_PARAMETER_SERVER
                    note = ("aggregate worker speed exceeds PS capacity "
                            f"{over} despite "
                            f"{ps_model.compression} compression")
        det = Detection(True, measured, predicted_speed, dev, action, note,
                        model_version=self.model_version)
        self.log.append(det)
        return det

    def mitigate_ps(self, ps_model: PSBottleneckModel) -> PSBottleneckModel:
        """§VI-B mitigation: provision one more parameter server.

        Rebuilt with `replace` so the per-tensor RPC term (`n_tensors`,
        `rpc_per_tensor`) and the wire compression scheme survive the
        mitigation — dropping them silently inflated capacity estimates
        for RPC-bound models.
        """
        return dataclasses.replace(ps_model, n_ps=ps_model.n_ps + 1)

    def mitigate_compression(self, ps_model: PSBottleneckModel,
                             scheme: str = "int8") -> PSBottleneckModel:
        """§VI-B mitigation: shrink the update payload — the capacity
        model's network term scales by `compression_ratio(scheme)`."""
        return dataclasses.replace(ps_model, compression=scheme)
