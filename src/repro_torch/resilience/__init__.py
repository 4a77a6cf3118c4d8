"""repro_torch.resilience — the recovery policies and the keyed
restore-stall draws the fleet engines share (the port's copy of the JAX
package's `resilience/policy.py`). The live retry runtime waits for
ROADMAP.md queue 1 item 5."""
from repro_torch.resilience.policy import (DegradationPolicy,
                                           ResilienceConfig, RetryPolicy,
                                           stall_from_uniforms, stall_pool)

__all__ = [
    "DegradationPolicy", "ResilienceConfig", "RetryPolicy",
    "stall_from_uniforms", "stall_pool",
]
