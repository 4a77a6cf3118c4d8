"""Device-idle ms a step of the traced window outside every span of the
program's train step (``repro_torch.step``): the trainer's sync on the
loss, its bookkeeping, the next batch and the next ``run_steps`` call."""
from portbench import program_spans


def read(run):
    return program_spans.idle_ms_outside(run, program_spans.STEP)
