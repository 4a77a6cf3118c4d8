"""Device ms a step of the operations launched inside the benchmark's span
around the trainer's optimizer update (AdamW)."""
from portbench.trace import SPAN_PREFIX


def read(run):
    if run.trace is None or run.trace.steps == 0:
        return None
    seconds = run.trace.span_device_seconds(SPAN_PREFIX + "optimizer")
    return 1e3 * seconds / run.trace.steps if seconds > 0.0 else None
