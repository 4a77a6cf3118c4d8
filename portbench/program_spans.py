"""Readings of the spans the program opens itself (`repro_torch.spans`,
named ``repro_torch.*``) in a traced window: the device ms a step of the
operations launched inside a span, and the device-idle ms a step that lies
inside a span or outside every span of a name.

Idleness is the window less the union of the device's operations, measured
where it overlaps the host's intervals, whatever the host was doing when a
gap began. Every reading is None where the trace holds no device operation
or no span of the name (a run on the CPU, or a program without the span).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

PREFIX = "repro_torch."
STEP = PREFIX + "step"
FORWARD = STEP + ".forward"
BACKWARD = STEP + ".backward"
CLIP = STEP + ".clip"
OPTIMIZER = STEP + ".optimizer"
SSD_BWD = PREFIX + "ssd_bwd"
BATCH = PREFIX + "trainer.batch"

Interval = Tuple[int, int]


def _found(run, name: str) -> bool:
    trace = run.trace
    return (trace is not None and bool(trace.device) and trace.steps > 0
            and bool(trace.spans(name)))


def device_ms(run, name: str) -> Optional[float]:
    """Device ms a step of the operations launched inside the spans
    called ``name``."""
    if not _found(run, name):
        return None
    return 1e3 * run.trace.span_device_seconds(name) / run.trace.steps


def idle_ms_inside(run, name: str) -> Optional[float]:
    """Device-idle ms a step inside the spans called ``name``."""
    if not _found(run, name):
        return None
    return _idle_ms(run, _spans(run.trace, name))


def idle_ms_outside(run, name: str) -> Optional[float]:
    """Device-idle ms a step of the window outside every span called
    ``name``."""
    if not _found(run, name):
        return None
    return _idle_ms(run, complement(_spans(run.trace, name),
                                    run.trace.window))


def _spans(trace, name: str) -> List[Interval]:
    return merge((s, e) for _, s, e, _ in trace.spans(name))


def _idle_ms(run, intervals: List[Interval]) -> float:
    trace = run.trace
    idle = complement(merge((s, e) for _, s, e, _ in trace.device),
                      trace.window)
    return overlap_ns(idle, intervals) / 1e6 / trace.steps


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals``, as disjoint intervals in order."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def complement(merged: List[Interval], window: Interval) -> List[Interval]:
    """What ``window`` holds outside the disjoint, ordered ``merged``."""
    lo, hi = window
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """The length of the intersection of two disjoint, ordered lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
