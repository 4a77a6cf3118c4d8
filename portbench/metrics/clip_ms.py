"""Device ms a step of the operations launched inside the program's span
around the gradients' clip to their global norm
(``repro_torch.step.clip``)."""
from portbench import program_spans


def read(run):
    return program_spans.device_ms(run, program_spans.CLIP)
