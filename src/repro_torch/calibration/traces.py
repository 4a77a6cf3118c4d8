"""Recorded provider-trace ingestion (docs/calibration.md §traces).

A *trace file* is a recorded market history — eviction timestamps and/or
spot-price samples for one (provider, region, gpu) cell — in JSON Lines
(one object per line) or a single JSON array. Recognized records:

  {"kind": "eviction", "t_h": 3.2, "lifetime_h": 3.2,
   "region": "us-central1", "gpu": "v100"}          # censored: true when
                                                    # the server survived
  {"kind": "price", "t_h": 0.0, "price": 0.11,
   "region": "us-east-1", "gpu": "v100"}

Two consumers share this parser:

* the `Recalibrator` refits lifetime laws from the observed (censored)
  lifetimes (`lifetimes_from_trace`);
* the chaos `TraceInjector` replays the same file as a `FaultTimeline`
  (hazard windows from eviction clusters and price excursions), so a
  recorded bad afternoon becomes a reproducible scenario.

The port's copy of the JAX package's `calibration/traces.py` (it imports
nothing of it).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One record of a provider trace (hours relative to trace start)."""
    t_h: float
    kind: str                         # "eviction" | "price"
    region: Optional[str] = None
    gpu: Optional[str] = None
    lifetime_h: Optional[float] = None
    censored: bool = False            # eviction records: survived horizon
    price: Optional[float] = None

    @classmethod
    def from_record(cls, rec: Mapping) -> "TraceEvent":
        kind = rec.get("kind")
        if kind not in ("eviction", "price"):
            raise ValueError(f"trace record kind {kind!r} not one of "
                             "('eviction', 'price'): {rec!r}"
                             .format(rec=rec))
        if "t_h" not in rec:
            raise ValueError(f"trace record missing 't_h': {rec!r}")
        return cls(t_h=float(rec["t_h"]), kind=kind,
                   region=rec.get("region"), gpu=rec.get("gpu"),
                   lifetime_h=(None if rec.get("lifetime_h") is None
                               else float(rec["lifetime_h"])),
                   censored=bool(rec.get("censored", False)),
                   price=(None if rec.get("price") is None
                          else float(rec["price"])))


def parse_trace(text: str) -> List[TraceEvent]:
    """Parse trace text: a JSON array, or JSON Lines (blank lines and
    `#` comment lines allowed). Events come back sorted by time."""
    stripped = text.lstrip()
    if stripped.startswith("["):
        records = json.loads(text)
    else:
        records = []
        for i, line in enumerate(text.splitlines(), 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"trace line {i} is not JSON: {e}") from e
    events = [TraceEvent.from_record(r) for r in records]
    return sorted(events, key=lambda e: e.t_h)


def load_trace(path: str) -> List[TraceEvent]:
    with open(path) as f:
        return parse_trace(f.read())


def lifetimes_from_trace(events: Sequence[TraceEvent],
                         region: Optional[str] = None,
                         gpu: Optional[str] = None) -> np.ndarray:
    """Observed lifetimes (hours) from the eviction records, optionally
    filtered to one (region, gpu). Censored records (survived the
    recording horizon) come back as np.inf — the same convention the
    `LifetimeLaw` samplers use, so `LifetimeModel.fit` consumes the
    array directly."""
    out = []
    for e in events:
        if e.kind != "eviction":
            continue
        if region is not None and e.region is not None and e.region != region:
            continue
        if gpu is not None and e.gpu is not None and e.gpu != gpu:
            continue
        if e.censored:
            out.append(np.inf)
        else:
            out.append(e.lifetime_h if e.lifetime_h is not None else e.t_h)
    return np.asarray(out, float)


def eviction_hazard_windows(events: Sequence[TraceEvent], n_workers: int,
                            bucket_h: float = 1.0
                            ) -> List[Tuple[float, float, float, Optional[str]]]:
    """Bucket eviction timestamps into `(start_h, end_h, hazard_per_h,
    region)` windows: the empirical hazard is the eviction count per
    bucket divided by the exposed fleet-hours (`n_workers * bucket_h`) —
    the rate a `PreemptionWave` reproduces in expectation."""
    if bucket_h <= 0:
        raise ValueError("bucket_h must be positive")
    by_bucket: Dict[Tuple[int, Optional[str]], int] = {}
    for e in events:
        if e.kind != "eviction" or e.censored:
            continue
        key = (int(e.t_h // bucket_h), e.region)
        by_bucket[key] = by_bucket.get(key, 0) + 1
    out = []
    for (b, region), count in sorted(by_bucket.items(),
                                     key=lambda kv: (kv[0][0],
                                                     kv[0][1] or "")):
        hazard = count / (max(n_workers, 1) * bucket_h)
        out.append((b * bucket_h, (b + 1) * bucket_h, hazard, region))
    return out


def price_hazard_windows(events: Sequence[TraceEvent], bid: float,
                         hazard_per_excess: float = 2.0
                         ) -> List[Tuple[float, float, float]]:
    """Contiguous spans where the recorded price meets/exceeds `bid`,
    as `(start_h, end_h, hazard_per_h)` windows. The hazard scales with
    the mean fractional excess over the bid (`hazard_per_excess` per
    unit of excess) — a price pinned 50 % over the bid revokes harder
    than one grazing it."""
    if bid <= 0:
        raise ValueError("bid must be positive")
    prices = [e for e in events if e.kind == "price" and e.price is not None]
    out: List[Tuple[float, float, float]] = []
    span_start: Optional[float] = None
    excesses: List[float] = []
    last_t: Optional[float] = None
    for e in prices:
        over = e.price >= bid
        if over and span_start is None:
            span_start = e.t_h
            excesses = []
        if over:
            excesses.append((e.price - bid) / bid)
        if not over and span_start is not None:
            out.append((span_start, e.t_h,
                        hazard_per_excess * float(np.mean(excesses))))
            span_start = None
        last_t = e.t_h
    if span_start is not None and last_t is not None and last_t > span_start:
        out.append((span_start, last_t,
                    hazard_per_excess * float(np.mean(excesses))))
    return [(a, b, h) for a, b, h in out if h > 0]
