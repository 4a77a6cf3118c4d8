"""Device ms a step of the operations launched inside the program's span
around ``loss.backward()`` (``repro_torch.step.backward``), the ones that
autograd's device thread launches included."""
from portbench import program_spans


def read(run):
    return program_spans.device_ms(run, program_spans.BACKWARD)
