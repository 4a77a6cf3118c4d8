"""Live-side retry execution: `call_with_retries` wraps one fallible
operation (checkpoint save, restore, replacement join) in a
`RetryPolicy`, emitting a ``retry`` event per attempt so the chaos
evaluator can score recovery cost (docs/resilience.md). The port's copy
of the JAX package's `resilience/runtime.py`."""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.resilience.policy import RetryPolicy, live_jitter_uniforms


class RetryExhausted(RuntimeError):
    """All attempts failed (or the deadline ran out); `.last` holds the
    final exception, `.attempts` how many were made."""

    def __init__(self, op: str, attempts: int, last: BaseException):
        super().__init__(f"{op}: {attempts} attempt(s) failed: {last}")
        self.op = op
        self.attempts = attempts
        self.last = last


def call_with_retries(fn: Callable[[], object], policy: RetryPolicy, *,
                      op: str = "op", seed: int = 0, key: int = 0,
                      sleep: Callable[[float], None] = time.sleep,
                      emit: Optional[Callable[..., None]] = None,
                      retry_on: tuple = (Exception,)):
    """Run ``fn`` under ``policy``. Returns ``(value, attempts)`` on
    success; raises `RetryExhausted` once attempts or the deadline are
    spent. ``emit(kind, payload)`` (the trainer's `_emit` signature) gets
    one ``retry`` event per attempt with the outcome and the backoff
    slept; ``sleep`` is injectable so chaos `VirtualClock` runs never
    block. Exceptions outside ``retry_on`` are non-transient and
    propagate immediately, unretried."""
    us = live_jitter_uniforms(policy, seed, key)
    spent = 0.0
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            out = fn()
        except retry_on as exc:           # noqa: BLE001 — rethrown below
            last = exc
            give_up = (attempt >= policy.max_attempts
                       or spent >= policy.deadline_s)
            delay = 0.0
            if not give_up:
                delay = min(policy.backoff(attempt, us[attempt - 1]),
                            policy.deadline_s - spent)
            if emit is not None:
                emit("retry", {"op": op, "attempt": attempt,
                               "outcome": "gave_up" if give_up else "fail",
                               "error": type(exc).__name__,
                               "backoff_s": delay})
            if give_up:
                raise RetryExhausted(op, attempt, exc) from exc
            sleep(delay)
            spent += delay
        else:
            if emit is not None:
                emit("retry", {"op": op, "attempt": attempt,
                               "outcome": "ok", "backoff_s": 0.0})
            return out, attempt
    raise RetryExhausted(op, policy.max_attempts, last)  # pragma: no cover
