"""Host seconds from the start of the process to the first timed step:
imports, the kernels' load (and their build in a checkout's first run), the
weights, the trainer and the checked steps that warm every shape up."""


def read(run):
    return run.setup_s
