"""Replay a *recorded* provider trace as a chaos fault script.

The scripted scenarios in `scenarios.py` invent their faults; this module
derives them from a measurement file instead. It reuses the calibration
layer's trace parser (`repro_torch.calibration.traces`) and compiles the
recorded history into the standard primitives:

  * eviction clusters -> `PreemptionWave`s (empirical hazard per bucket:
    evictions / exposed fleet-hours), region-scoped when the records are;
  * spot-price excursions above the fleet's bid -> `PriceSpike`s whose
    hazard scales with the mean fractional excess over the bid.

Because the output is ordinary primitives, the replay inherits the whole
chaos contract for free: keyed hazard draws, engine parity, ground-truth
spans and the smoke gates — a recorded bad afternoon becomes a
reproducible, scoreable scenario.

The port's copy of the JAX package's `chaos/trace_injector.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.calibration.traces import (TraceEvent,
                                            eviction_hazard_windows,
                                            load_trace, price_hazard_windows)
from repro_torch.chaos.injectors import (FaultTimeline, PreemptionWave,
                                         PriceSpike)


@dataclasses.dataclass(frozen=True)
class TraceInjector:
    """A recorded trace compiled against a fleet size and a bid."""
    events: Tuple[TraceEvent, ...]
    n_workers: int = 4
    bid: Optional[float] = None        # None = ignore price records
    bucket_h: float = 0.5              # eviction-clustering granularity
    hazard_per_excess: float = 2.0     # price hazard per unit bid excess

    @classmethod
    def from_file(cls, path: str, n_workers: int = 4,
                  bid: Optional[float] = None,
                  bucket_h: float = 0.5,
                  hazard_per_excess: float = 2.0) -> "TraceInjector":
        return cls(tuple(load_trace(path)), n_workers=n_workers, bid=bid,
                   bucket_h=bucket_h, hazard_per_excess=hazard_per_excess)

    def faults(self) -> Tuple[object, ...]:
        """The trace as chaos primitives, in window-start order."""
        out: List[object] = []
        for start, end, hazard, region in eviction_hazard_windows(
                self.events, self.n_workers, self.bucket_h):
            out.append(PreemptionWave(start, end - start, hazard,
                                      region=region))
        if self.bid is not None:
            for start, end, hazard in price_hazard_windows(
                    self.events, self.bid, self.hazard_per_excess):
                out.append(PriceSpike(start, end - start, hazard))
        return tuple(sorted(out, key=lambda f: (f.start_h, f.kind)))

    def timeline(self, roster: Sequence[Tuple],
                 seed: int = 0) -> FaultTimeline:
        """Compile the replay against a launch roster — same contract as
        `Scenario.timeline`."""
        return FaultTimeline(self.faults(), roster, seed=seed)
