"""Bounded admission queue with deadline-aware load shedding.

The gateway's front door (docs/serving.md): a request is *admitted* when
the queue has room, waits FIFO within its priority class, and is *shed*
(the HTTP-429 analogue) when the queue is full on arrival or when its
queue time exceeds `queue_budget_s` before a replica picks it up — a
request the user would have abandoned anyway is never dispatched.

Shedding on budget expiry records the expiry instant (`enqueued_s +
budget`), not the instant the expiry was noticed, so scorecards are
independent of when the engine happened to look — the same
order-independence contract the fleet engines' keyed draws follow.

The port's copy of the JAX package's `serving/queue.py` (it imports
nothing of it).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.requests import Request


class AdmissionQueue:
    """FIFO-within-priority bounded queue (priority 0 pops first)."""

    def __init__(self, capacity: int = 64,
                 queue_budget_s: float = math.inf) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.queue_budget_s = float(queue_budget_s)
        self._by_prio: Dict[int, deque] = {}
        self._size = 0
        #: (request, reason, shed_time) terminal shed records
        self.shed: List[Tuple[Request, str, float]] = []

    def __len__(self) -> int:
        return self._size

    # ----------------------------------------------------------- admission
    def offer(self, req: Request, now: float) -> bool:
        """Admit `req` or shed it with reason ``queue_full``."""
        if self._size >= self.capacity:
            self.shed.append((req, "queue_full", now))
            return False
        self._enqueue(req, now, front=False)
        return True

    def requeue_front(self, req: Request, now: float) -> None:
        """Hand a revoked replica's in-flight request back to the head of
        its priority class. Handovers bypass the capacity bound — the
        request was already admitted once; bouncing it now would turn a
        *warned* revocation into a drop."""
        self._enqueue(req, now, front=True)

    def _enqueue(self, req: Request, now: float, front: bool) -> None:
        req.enqueued_s = now
        req.deadline_s = now + self.queue_budget_s
        dq = self._by_prio.setdefault(req.priority, deque())
        (dq.appendleft if front else dq.append)(req)
        self._size += 1

    # ------------------------------------------------------------ dispatch
    def pop(self, now: float) -> Optional[Request]:
        """Next dispatchable request (highest class, FIFO inside it),
        shedding every expired request encountered on the way."""
        self.shed_expired(now)
        for prio in sorted(self._by_prio):
            dq = self._by_prio[prio]
            if dq:
                self._size -= 1
                return dq.popleft()
        return None

    def shed_expired(self, now: float) -> int:
        """Shed every queued request whose budget expired by `now`;
        returns how many. Shed time is the expiry instant."""
        n = 0
        for dq in self._by_prio.values():
            keep = deque()
            while dq:
                req = dq.popleft()
                if now > req.deadline_s:
                    self.shed.append((req, "queue_budget", req.deadline_s))
                    self._size -= 1
                    n += 1
                else:
                    keep.append(req)
            dq.extend(keep)
        return n

    def next_deadline(self) -> float:
        """Earliest budget expiry among queued requests (inf when none) —
        the simulator's shed-event candidate."""
        return min((req.deadline_s for dq in self._by_prio.values()
                    for req in dq), default=math.inf)

    def drain(self) -> List[Request]:
        """Remove and return everything still queued (end-of-run sweep)."""
        out = [req for prio in sorted(self._by_prio)
               for req in self._by_prio[prio]]
        self._by_prio.clear()
        self._size = 0
        return out
