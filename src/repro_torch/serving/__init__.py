"""`repro_torch.serving` — revocation-tolerant serving (the twin of the
JAX package's `serving/`).

Three layers, mirroring the training stack's split:

* **Gateway** (`GatewayEngine`): continuous batching over the real
  model — per-slot decode positions in one shared KV/SSM state, join
  resets and sampling, on the session's device.
* **Admission & policy** (`AdmissionQueue`, `ServingDegradationPolicy`):
  bounded queueing with deadline sheds, and quorum-style capacity tiers
  stepped down before the latency SLO breaks.
* **Fleet** (`ReplicaSet`, `ServingFleetSim`, `plan_serving`): replicas
  on revocable instances under provider lifetime laws — warned-revocation
  drain + handover, silent-revocation requeue-with-retry, hedged
  re-dispatch — scored as event/batched parity ensembles and ranked
  against an SLO. Host NumPy on every device, as in the JAX package.
"""
from repro_torch.serving.degradation import (  # noqa: F401
    TIERS, ServingDegradationPolicy)
from repro_torch.serving.engine import GatewayEngine  # noqa: F401
from repro_torch.serving.planner import (ServingPlan,  # noqa: F401
                                         ServingSLO, plan_serving)
from repro_torch.serving.queue import AdmissionQueue  # noqa: F401
from repro_torch.serving.replica import (ACTIVE, DOWN,  # noqa: F401
                                         DRAINING, Replica, ReplicaSet)
from repro_torch.serving.requests import (COMPLETED, DROPPED,  # noqa: F401
                                          SHED, Request, RequestOutcome)
from repro_torch.serving.simulator import (  # noqa: F401
    ServingFleetSim, ServingScript, ServingSimResult, ServingWorkload,
    summarize_serving)
