"""§V transient-server models and the fleet simulators (the port's copy
of the JAX package's `core/transient/`): the event engine (`fleet`), the
lockstep NumPy engine (`fleet_batched`) and the device engine
(`fleet_jit`)."""
from repro_torch.core.transient.revocation import (  # noqa: F401
    LifetimeModel, REGION_GPU_PARAMS, RevocationSampler,
)
from repro_torch.core.transient.startup import StartupModel  # noqa: F401
from repro_torch.core.transient.replacement import (  # noqa: F401
    ReplacementModel)
from repro_torch.core.transient.fleet import (  # noqa: F401
    FleetEvent, FleetSim)
from repro_torch.core.transient.fleet_batched import (  # noqa: F401
    FleetDraws, run_batched)
