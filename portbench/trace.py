"""One traced window under `torch.profiler`, reduced to what the per-layer
readers take: the device's operations, the host's operations, and the spans
the benchmark opens around its calls into the program (named
``portbench.*``).

A device operation is tied to the host operation that launched it by the
profiler's correlation ids, so a span's device time is that of the kernels
launched while it was open, on whatever stream or thread they ran.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Tuple

SPAN_PREFIX = "portbench."
WINDOW_SPAN = SPAN_PREFIX + "window"
STEP_SPAN = SPAN_PREFIX + "train_step"
#: device gaps shorter than this are summed under one name
SHORT_GAP_NS = 10_000

Event = Tuple[str, int, int, int]   # name, start ns, end ns, correlation id


def span(name: str):
    """A span of the benchmark's own (a no-op while nothing traces)."""
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _end_ns(e) -> int:
    end = getattr(e, "end_ns", None)
    return end() if end is not None else e.start_ns() + e.duration_ns()


class Trace:
    def __init__(self, device: List[Event], host: List[Event],
                 window: Tuple[int, int]):
        lo, hi = window
        self.window = window
        self.window_s = (hi - lo) / 1e9
        self.device = sorted((e for e in device if e[2] > lo and e[1] < hi),
                             key=lambda e: e[1])
        self.host = sorted(host, key=lambda e: e[1])
        self._host_by_corr = {e[3]: e for e in host}
        self._bench = [e for e in self.host if e[0].startswith(SPAN_PREFIX)]
        self.steps = len(self.spans(STEP_SPAN))

    @classmethod
    def from_kineto(cls, events) -> "Trace":
        from torch.autograd import DeviceType
        device, host, window = [], [], None
        for e in events:
            name = e.name()
            start, end = e.start_ns(), _end_ns(e)
            if e.device_type() == DeviceType.CUDA:
                if not (e.is_user_annotation() or
                        name.startswith(SPAN_PREFIX)):
                    device.append((name, start, end,
                                   e.linked_correlation_id()))
            elif e.linked_correlation_id() == 0:
                host.append((name, start, end, e.correlation_id()))
                if name == WINDOW_SPAN:
                    window = (start, end)
        if window is None:
            raise RuntimeError("the trace holds no window span")
        return cls(device, host, window)

    # ------------------------------------------------------------- reads
    def spans(self, name: str) -> List[Event]:
        return [e for e in self.host if e[0] == name]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the
        device."""
        lo, hi = self.window
        busy, cur_s, cur_e = 0, None, None
        for _, s, e, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def device_span_s(self) -> float:
        """From the window's first device operation to its last."""
        if not self.device:
            return 0.0
        return (max(e[2] for e in self.device) - self.device[0][1]) / 1e9

    def kernel_seconds(self, fragment: str) -> float:
        return sum(e - s for n, s, e, _ in self.device if fragment in n) / 1e9

    def span_device_seconds(self, name: str) -> float:
        """Device seconds of the operations launched inside the spans
        called ``name``."""
        spans = sorted((s, e) for _, s, e, _ in self.spans(name))
        starts = [s for s, _ in spans]
        total = 0
        for _, s, e, corr in self.device:
            launch = self._host_by_corr.get(corr)
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch[1]) - 1
            if i >= 0 and launch[1] <= spans[i][1]:
                total += e - s
        return total / 1e9

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took the most time, and the idle
        gaps of the window summed by what the host was doing as each
        began, largest first (seconds)."""
        ops: Dict[str, float] = {}
        for n, s, e, _ in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
        gaps: Dict[str, float] = {}
        lo, hi = self.window
        prev = lo
        starts = [e[1] for e in self.host]
        for _, s, e, _ in self.device + [("", hi, hi, 0)]:
            if s - prev >= SHORT_GAP_NS:
                label = self._host_at(prev, starts)
                gaps[label] = gaps.get(label, 0.0) + (s - prev) / 1e9
            elif s > prev:
                key = "gaps under 10 us"
                gaps[key] = gaps.get(key, 0.0) + (s - prev) / 1e9
            prev = max(prev, e)
        rank = lambda d: [[k, v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}

    def _host_at(self, t: int, starts: List[int]) -> str:
        """The innermost host operation open at ``t`` (looked for among
        the 4,096 that began last), under the benchmark's innermost
        span."""
        bench = next((n for n, s, e, _ in reversed(self._bench)
                      if s <= t <= e), "outside the spans")
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 4097, -1), -1):
            name, s, e, _ = self.host[j]
            if e >= t and not name.startswith(SPAN_PREFIX):
                return f"{bench}: {name}"
        return f"{bench}: python"


def capture(body: Callable[[], None], on_card: bool = True) -> Trace:
    """Run ``body`` under the profiler (the host, and the card where
    ``on_card``), inside the window span, the card synchronised at both
    ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * on_card
    sync()
    with profile(activities=activities) as prof:
        with span("window"):
            body()
            sync()
    return Trace.from_kineto(prof.profiler.kineto_results.events())
