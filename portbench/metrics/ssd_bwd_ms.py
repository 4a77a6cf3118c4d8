"""Device ms a step of the operations launched inside the program's span
around the SSD scan's backward (``repro_torch.ssd_bwd``, one an SSD layer
a backward, on autograd's device thread)."""
from portbench import program_spans


def read(run):
    return program_spans.device_ms(run, program_spans.SSD_BWD)
