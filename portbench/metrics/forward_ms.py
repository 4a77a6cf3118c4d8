"""Device ms a step of the operations launched inside the program's span
around the forward and its loss (``repro_torch.step.forward``, once a
microbatch)."""
from portbench import program_spans


def read(run):
    return program_spans.device_ms(run, program_spans.FORWARD)
