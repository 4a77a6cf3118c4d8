"""repro_torch.resilience — recovery layer: deterministic retry/backoff,
quorum degradation tiers, and keyed restore-stall draws shared by the
live `TransientTrainer` and the three fleet engines (the port's copy of
the JAX package's `resilience/`)."""
from repro_torch.resilience.policy import (DegradationPolicy,
                                           ResilienceConfig, RetryPolicy,
                                           live_jitter_uniforms,
                                           stall_from_uniforms, stall_pool)
from repro_torch.resilience.runtime import RetryExhausted, call_with_retries

__all__ = [
    "DegradationPolicy", "ResilienceConfig", "RetryPolicy",
    "RetryExhausted", "call_with_retries", "live_jitter_uniforms",
    "stall_from_uniforms", "stall_pool",
]
