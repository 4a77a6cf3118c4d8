"""Recovery policies (docs/resilience.md, DESIGN.md §8).

Three frozen, hashable configs compose into `ResilienceConfig`, the
value carried by `RunConfig.resilience` and `FleetSim(resilience=...)`:

* `RetryPolicy` — bounded exponential backoff with symmetric jitter and
  a per-operation deadline. The schedule is a pure function of the
  attempt index and a uniform draw, so the live trainer and the three
  fleet engines can reproduce the *same* delays from the same keyed
  uniform streams (the PR 5/7 parity contract extends to recovery).
* `DegradationPolicy` — quorum-based tiers keyed on the alive fraction
  of the launch roster: ``continue`` (full speed), ``shrink_batch``
  (effective throughput × `shrink_factor`), ``pause`` (no forward
  progress until membership recovers above `quorum`).
* `ResilienceConfig` — the two policies plus the sim-side restore
  failure probability and an independent seed for the recovery streams.

Sim-side restore stalls are drawn from counter-based streams keyed on
``(seed, tag, generation)`` exactly like `FleetDraws` replacement pools:
one `(n, slots, 2K)` uniform block per generation level, row ``j`` a
fixed slice of the stream whatever the ensemble width, so every engine
(and any `n`) sees identical delays for trajectory ``j``.

The port's copy of the JAX package's `resilience/policy.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: stream tag for restore-retry uniforms (cf. fleet_batched's
#: _TAG_INITIAL / _TAG_JOIN and the chaos injector tags)
_TAG_RESTORE = 0x5E11E
#: stream tag for live-side retry jitter (per holder/op key)
_TAG_LIVE = 0x5E1FE


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: the delay after the ``attempt``-th
    failure (1-based) is ``min(max_delay_s, base_delay_s *
    multiplier**(attempt-1))`` scaled by ``1 + jitter*(2u-1)`` for a
    uniform ``u`` — deterministic given the draw, bounded by
    ``max_delay_s * (1 + jitter)``, and the cumulative sleep never
    exceeds ``deadline_s``."""
    max_attempts: int = 4
    base_delay_s: float = 0.5
    multiplier: float = 2.0
    max_delay_s: float = 8.0
    jitter: float = 0.25
    deadline_s: float = 30.0

    def backoff(self, attempt: int, u: float) -> float:
        base = min(self.max_delay_s,
                   self.base_delay_s * self.multiplier ** (attempt - 1))
        return base * (1.0 + self.jitter * (2.0 * float(u) - 1.0))


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Quorum tiers on the alive fraction ``n_alive / roster_size``:
    ``frac < quorum`` → ``pause``; ``frac < shrink_below`` →
    ``shrink_batch``; else ``continue``. The defaults (both thresholds
    0) never degrade, so `ResilienceConfig()` is behavior-preserving."""
    quorum: float = 0.0
    shrink_below: float = 0.0
    shrink_factor: float = 0.5

    def tier(self, n_alive: int, n_total: int) -> str:
        frac = n_alive / max(n_total, 1)
        if frac < self.quorum:
            return "pause"
        if frac < self.shrink_below:
            return "shrink_batch"
        return "continue"

    def speed_factor(self, n_alive: int, n_total: int) -> float:
        return {"pause": 0.0, "shrink_batch": self.shrink_factor,
                "continue": 1.0}[self.tier(n_alive, n_total)]


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """The recovery layer's single knob bundle. `restore_fail_p` is the
    sim-side per-attempt probability that reloading the checkpoint after
    a stock-chief revocation fails (store outage, torn read): each
    leading failure costs one backoff delay, so the revoked trajectory
    stalls for the keyed-deterministic retry schedule before
    recomputing. The default (0.0) adds no stalls."""
    retry: RetryPolicy = RetryPolicy()
    degradation: DegradationPolicy = DegradationPolicy()
    restore_fail_p: float = 0.0
    seed: int = 0


def stall_from_uniforms(retry: RetryPolicy, fail_p: float,
                        u: np.ndarray) -> np.ndarray:
    """Restore-stall seconds from a ``(..., 2K)`` uniform block
    (``K = retry.max_attempts``): the first K uniforms decide failures
    (``u < fail_p``), the last K supply jitter; the stall is the sum of
    backoff delays over the *leading* run of failures, clamped to the
    deadline. Pure NumPy float64 — the event and batched engines index
    it directly and the jit engine ships the materialized pool to
    device, so all three consume bit-identical delays."""
    u = np.asarray(u, np.float64)
    k = u.shape[-1] // 2
    u_fail, u_jit = u[..., :k], u[..., k:]
    lead = np.cumprod(u_fail < fail_p, axis=-1).astype(bool)
    i = np.arange(1, k + 1, dtype=np.float64)
    base = np.minimum(retry.max_delay_s,
                      retry.base_delay_s * retry.multiplier ** (i - 1.0))
    delays = base * (1.0 + retry.jitter * (2.0 * u_jit - 1.0))
    total = np.where(lead, delays, 0.0).sum(axis=-1)
    return np.minimum(float(retry.deadline_s), total)


def stall_pool(res: ResilienceConfig, sim_seed: int, n: int, slots: int,
               gen: int) -> np.ndarray:
    """The ``(n, slots)`` restore-stall matrix for generation ``gen`` —
    one keyed stream per level, same scheme as `FleetDraws._level`."""
    ss = np.random.SeedSequence(((sim_seed + res.seed) % 2 ** 32,
                                 _TAG_RESTORE, int(gen)))
    u = np.random.default_rng(ss).random(
        (n, slots, 2 * res.retry.max_attempts))
    return stall_from_uniforms(res.retry, res.restore_fail_p, u)


def live_jitter_uniforms(retry: RetryPolicy, seed: int,
                         key: int) -> np.ndarray:
    """Jitter uniforms for one live retried operation, keyed on
    ``(seed, op key)`` — deterministic under a fixed `RunConfig.seed`.
    Negative keys (the trainer tags its restore stream -1) wrap rather
    than crash: SeedSequence entropy must be non-negative."""
    ss = np.random.SeedSequence((seed % 2 ** 32, _TAG_LIVE,
                                 int(key) % 2 ** 32))
    return np.random.default_rng(ss).random(retry.max_attempts)
