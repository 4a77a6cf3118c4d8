"""repro_torch.chaos — scripted fault scenarios with ground-truth-scored
detection & mitigation (the port's copy of the JAX package's `chaos/`):

* `injectors` — fault primitives and the `FaultTimeline` the fleet
  engines consume;
* `trace_injector` — a recorded provider trace replayed as those
  primitives;
* `scenarios` — the named, seeded scenario registry;
* `evaluator` / `runner` — ground-truth scoring of EventBus histories and
  serving fleets, and the scenario runner behind `Session.chaos` /
  `python -m repro_torch chaos`."""
from repro_torch.chaos.evaluator import EXPECTED_ACTIONS, score_history
from repro_torch.chaos.injectors import (CheckpointOutage, FaultTimeline,
                                         PSCrash, PreemptionWave,
                                         PriceSpike, StragglerFault)
from repro_torch.chaos.runner import (VirtualClock, run_scenario,
                                      run_scenarios)
from repro_torch.chaos.scenarios import (LiveFault, LivePlan, Scenario,
                                         get_scenario, list_scenarios,
                                         register_scenario)

__all__ = [
    "CheckpointOutage", "EXPECTED_ACTIONS", "FaultTimeline", "LiveFault",
    "LivePlan", "PSCrash", "PreemptionWave", "PriceSpike", "Scenario",
    "StragglerFault", "VirtualClock", "get_scenario", "list_scenarios",
    "register_scenario", "run_scenario", "run_scenarios", "score_history",
]
