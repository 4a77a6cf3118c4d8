"""Request objects shared by the gateway engine and the fleet simulator.

A `Request` is one user generation: it arrives at `arrival_s`, wants
`max_tokens` decoded tokens, and carries a priority class (0 = high;
higher numbers shed first under degradation). The real gateway attaches
the actual prompt token ids; the fleet simulator only needs the counts.

`remaining` tracks decode progress so a warned-revocation handover can
move a half-served request to a survivor without losing tokens; a silent
revocation resets it to `max_tokens` (stock restart-from-scratch, the
progress the paper's §V revocation accounting charges you for).

The port's copy of the JAX package's `serving/requests.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

#: terminal states a request can end in — exactly one of these per request
COMPLETED = "completed"
SHED = "shed"           # admission control: queue full / budget / degraded
DROPPED = "dropped"     # lost in-flight to a revocation (or retries exhausted)


@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    prompt_tokens: int
    max_tokens: int
    priority: int = 1                      # 0 = high; sheds last
    prompt: Optional[Sequence[int]] = None  # token ids (real gateway only)
    deadline_s: float = math.inf           # absolute queue-time budget expiry

    # mutable serving state
    remaining: int = -1                    # decode tokens still owed
    attempts: int = 0                      # requeue-with-retry count
    enqueued_s: float = 0.0                # last time it entered a queue

    def __post_init__(self) -> None:
        if self.max_tokens < 1:
            raise ValueError(f"request {self.rid}: max_tokens must be >= 1")
        if self.remaining < 0:
            self.remaining = self.max_tokens


@dataclasses.dataclass
class RequestOutcome:
    """Terminal record for one request (the scorecard unit)."""
    rid: int
    status: str                            # COMPLETED / SHED / DROPPED
    arrival_s: float
    finished_s: float
    priority: int
    tokens: int = 0                        # tokens actually decoded
    reason: str = ""                       # shed/drop cause
    token_ids: Optional[List[int]] = None  # real gateway only

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.arrival_s
