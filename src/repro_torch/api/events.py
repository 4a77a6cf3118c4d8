"""Tiny synchronous event bus wiring the Session facade to the runtime — a
copy of the JAX package's `api/events.py` (the port imports nothing of it).
The port's `Session.serve` emits ``serve``; the other kinds below come
with the slices that port their emitters.

The trainer (and any future provider/backend) emits flat `(kind, payload)`
events; the Session forwards them onto a bus so callers can observe a run
without threading callbacks through every layer. Kinds emitted today:

  step                {step, loss}
  epoch               {step, kind, member_id, epoch, n_alive}
  checkpoint          {step, sizes}
  checkpoint_failed   {step, failures[, attempts, error]}
                                              (chaos ckpt-store outage;
                                               attempts/error appear when a
                                               resilience retry gave up)
  detection           {step, bottleneck, action, deviation, model_version}
  restore             {step}
  mitigation          {step, action, n_ps, grad_compression, ...}
  fault               {step, fault, ...}      (chaos injections)
  handler_error       {kind, handler, error}  (a subscriber raised)

Recovery kinds (resilience enabled — docs/resilience.md):

  retry               {op, attempt, outcome, backoff_s[, error]}
                                              (outcome: ok|fail|gave_up)
  restore_fallback    {step, depth, error}    (a corrupt generation skipped)
  restore_failed      {error}                 (every generation bad: fresh init)
  lease_handover      {step, holder, revoked_member}
  degradation         {step, tier, n_alive, roster_size}
                                              (tier: continue|shrink|pause,
                                               emitted on transitions only)

Calibration kinds (recalibration armed — docs/calibration.md):

  model_drift         {step, deviation, model_version}
                                              (CUSUM confirmed a persistent
                                               prediction/measurement shift)
  model_refit         {step, model_version, old_speed, new_speed, n_obs}
                                              (the cluster_speed estimator
                                               refit from profiler history;
                                               model_version is the new
                                               ModelStore version)

Subscribe to a specific kind or to "*" for everything. Handlers run inline
on the training thread — keep them cheap. A handler that raises is
*isolated*: the exception is swallowed, `handler_errors` is incremented and
a `handler_error` event is emitted, so one bad observer can never kill the
training loop it is observing.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

Handler = Callable[[str, Dict[str, Any]], None]


@dataclasses.dataclass
class Event:
    kind: str
    payload: Dict[str, Any]


class EventBus:
    def __init__(self, keep_history: int = 10_000):
        self._subs: Dict[str, List[Handler]] = defaultdict(list)
        self._keep = keep_history
        self.history: List[Event] = []
        #: total subscriber exceptions swallowed by `emit`
        self.handler_errors = 0

    def subscribe(self, kind: str, handler: Handler) -> Handler:
        """Register `handler` for `kind` ("*" = all). Returns the handler so
        this can be used as a decorator via `bus.on(kind)`."""
        self._subs[kind].append(handler)
        return handler

    def on(self, kind: str) -> Callable[[Handler], Handler]:
        return lambda fn: self.subscribe(kind, fn)

    def emit(self, kind: str, /, **payload: Any) -> None:
        # `kind` is positional-only so payloads may themselves carry a
        # "kind" key (e.g. the trainer's epoch events)
        if self._keep:
            self.history.append(Event(kind, payload))
            if len(self.history) > self._keep:
                del self.history[: len(self.history) - self._keep]
        failures: List[Tuple[Handler, Exception]] = []
        for handler in (*self._subs.get(kind, ()), *self._subs.get("*", ())):
            try:
                handler(kind, payload)
            except Exception as e:  # isolate observers from the run
                self.handler_errors += 1
                failures.append((handler, e))
        # report after the delivery loop so one bad handler cannot starve
        # the rest; never recurse on handler_error itself (a raising
        # handler_error subscriber would otherwise loop forever)
        if failures and kind != "handler_error":
            for handler, e in failures:
                self.emit("handler_error", kind=kind,
                          handler=getattr(handler, "__qualname__",
                                          repr(handler)),
                          error=f"{type(e).__name__}: {e}")

    def of_kind(self, kind: str) -> List[Event]:
        return [e for e in self.history if e.kind == kind]
