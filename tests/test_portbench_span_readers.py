"""The benchmark's readers of the program's spans (`program_spans.py` and
its six metrics, under `portbench/`) on traces built by hand: device ms
inside a span, device-idle ms inside or outside spans, each against a
closed form, and None where the trace holds no device operation or no
span of the name."""
import pathlib
import random
import sys
import types

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness, program_spans as ps  # noqa: E402
from portbench.trace import STEP_SPAN, Trace  # noqa: E402

US = 1_000   # ns
READERS = ["forward_ms", "backward_ms", "clip_ms", "ssd_bwd_ms",
           "between_steps_idle_ms", "input_wait_ms"]


def _step(o):
    """One step at offset ``o`` (us): device operations, the host's
    launches and spans. The SSD backward's span and its launches stand for
    autograd's thread, inside the main thread's backward span; the last
    operation is launched by the trainer outside every span."""
    ops = [(100, 180), (180, 250), (250, 330), (330, 360), (380, 390),
           (390, 430), (470, 480)]
    launched = [70, 120, 180, 250, 320, 350, 470]
    spans = [(ps.BATCH, 10, 40), ("portbench.train_step", 45, 460),
             (ps.STEP, 50, 450), (ps.FORWARD, 60, 150),
             (ps.BACKWARD, 160, 300), (ps.SSD_BWD, 170, 220),
             (ps.CLIP, 310, 330), (ps.OPTIMIZER, 340, 440)]
    corr = [o + k + 1 for k in range(len(ops))]
    device = [(f"kernel{k}", (o + s) * US, (o + e) * US, c)
              for k, ((s, e), c) in enumerate(zip(ops, corr))]
    host = [("cudaLaunchKernel", (o + t) * US, (o + t + 2) * US, c)
            for t, c in zip(launched, corr)]
    host += [(name, (o + s) * US, (o + e) * US, 0) for name, s, e in spans]
    return device, host


def _run(drop=(), steps=2, device_ops=True):
    device, host = [], []
    for k in range(steps):
        d, h = _step(500 * k)
        device += d
        host += [e for e in h if e[0] not in drop]
    trace = Trace(device if device_ops else [], host, (0, 1000 * US))
    return types.SimpleNamespace(trace=trace)


def _read(name, run):
    return harness.load(REPO / "portbench" / "metrics"
                        / f"{name}.py").read(run)


# a step of `_step` (us): forward launches operations 0 and 1 (80 + 70),
# backward 2 and 3 (80 + 30), of which the SSD backward 2, the clip 4
# (10), the optimizer 5 (40); the device is busy [100, 360], [380, 430]
# and [470, 480], so of the window's 180 idle us a step 30 lie inside the
# batch's span, 90 inside the step's ([50, 100], [360, 380], [430, 450])
# and 90 outside it
CLOSED = {"forward_ms": 0.150, "backward_ms": 0.110, "ssd_bwd_ms": 0.080,
          "clip_ms": 0.010, "between_steps_idle_ms": 0.090,
          "input_wait_ms": 0.030}


@pytest.mark.parametrize("name", READERS)
def test_reader_equals_its_closed_form(name):
    assert _read(name, _run()) == pytest.approx(CLOSED[name], rel=1e-12)


def test_step_parts_sum_to_the_step_and_optimizer_reads_its_span():
    run = _run()
    parts = sum(ps.device_ms(run, n) for n in
                (ps.FORWARD, ps.BACKWARD, ps.CLIP, ps.OPTIMIZER))
    assert ps.device_ms(run, ps.OPTIMIZER) == pytest.approx(0.040)
    assert parts == pytest.approx(ps.device_ms(run, ps.STEP), rel=1e-12)
    assert ps.device_ms(run, ps.SSD_BWD) <= ps.device_ms(run, ps.BACKWARD)


def test_idle_between_and_inside_steps_is_the_windows_idle():
    run = _run()
    trace = run.trace
    window_idle_ms = 1e3 * (trace.window_s - trace.busy_s()) / trace.steps
    inside = ps.idle_ms_inside(run, ps.STEP)
    assert inside == pytest.approx(0.090)
    assert inside + _read("between_steps_idle_ms", run) == \
        pytest.approx(window_idle_ms, rel=1e-12)
    assert _read("between_steps_idle_ms", run) <= window_idle_ms


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_device_ops_spans_or_trace(name):
    assert _read(name, types.SimpleNamespace(trace=None)) is None
    assert _read(name, _run(device_ops=False)) is None
    everything = (ps.BATCH, ps.STEP, ps.FORWARD, ps.BACKWARD, ps.SSD_BWD,
                  ps.CLIP, ps.OPTIMIZER)
    assert _read(name, _run(drop=everything)) is None
    assert _read(name, _run(drop=(STEP_SPAN,))) is None


def test_a_span_missing_in_one_cell_leaves_the_others():
    run = _run(drop=(ps.SSD_BWD,))
    assert _read("ssd_bwd_ms", run) is None
    assert _read("backward_ms", run) == pytest.approx(CLOSED["backward_ms"])


def _grid(intervals, lo, hi):
    return {t for s, e in intervals for t in range(max(s, lo), min(e, hi))}


@pytest.mark.parametrize("seed", range(6))
def test_interval_arithmetic_against_a_unit_grid(seed):
    rng = random.Random(seed)

    def draw(n):
        out = []
        for _ in range(n):
            s = rng.randrange(-20, 220)
            out.append((s, s + rng.randrange(0, 40)))
        return out

    lo, hi = 0, 200
    raw_a, raw_b = draw(12), draw(9)
    a, b = ps.merge(raw_a), ps.merge(raw_b)
    assert all(e1 < s2 for (_, e1), (s2, _) in zip(a, a[1:]))
    assert _grid(a, -100, 400) == _grid(raw_a, -100, 400)
    outside = ps.complement(a, (lo, hi))
    assert _grid(outside, lo, hi) == set(range(lo, hi)) - _grid(a, lo, hi)
    assert all(lo <= s < e <= hi for s, e in outside)
    assert ps.overlap_ns(a, b) == len(_grid(raw_a, -100, 400)
                                      & _grid(raw_b, -100, 400))
