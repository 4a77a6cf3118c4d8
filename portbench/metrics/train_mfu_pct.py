"""Model FLOPs a step (the configuration's reference counts them: 6 a weight
and token, with attention's or the SSD's products; recomputation not
counted) over the step's time on the device timeline of the traced window
and the H100's 989 TFLOP/s in bf16."""
from portbench import yardstick


def read(run):
    if run.trace is None or run.trace.steps == 0:
        return None
    step_s = run.trace.device_span_s() / run.trace.steps
    if step_s <= 0.0:
        return None
    return 100.0 * run.train_flops() / step_s / yardstick.PEAK_BF16_FLOPS
