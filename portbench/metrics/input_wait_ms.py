"""Device-idle ms a step inside the program's span around the loader's
next global batch and its copy to the card
(``repro_torch.trainer.batch``): the time a step waits for its data."""
from portbench import program_spans


def read(run):
    return program_spans.idle_ms_inside(run, program_spans.BATCH)
