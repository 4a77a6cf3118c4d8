"""Every token of the steps completed in the window, over the window's host
time (the device synchronised at its end)."""


def read(run):
    if run.steps == 0:
        return None
    return run.steps * run.tokens_per_step / run.window_s
