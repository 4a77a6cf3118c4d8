"""repro_torch.chaos — fault primitives, the `FaultTimeline` the fleet
engines consume, and the fleet scenarios (the port's copy of the JAX
package's `chaos/injectors.py` and `chaos/scenarios.py`). The evaluator
and the scenario runner wait for ROADMAP.md queue 1 item 13."""
from repro_torch.chaos.injectors import (CheckpointOutage, FaultTimeline,
                                         PSCrash, PreemptionWave,
                                         PriceSpike, StragglerFault)
from repro_torch.chaos.scenarios import (LiveFault, LivePlan, Scenario,
                                         get_scenario, list_scenarios,
                                         register_scenario)

__all__ = [
    "CheckpointOutage", "FaultTimeline", "LiveFault", "LivePlan",
    "PSCrash", "PreemptionWave", "PriceSpike", "Scenario",
    "StragglerFault", "get_scenario", "list_scenarios",
    "register_scenario",
]
