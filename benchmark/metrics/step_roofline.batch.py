"""The least time the card could take for a step's work (the
configuration's work file, benchmark/work/, against the published H100
peaks) over the step's kernel time, in %."""


def read(run):
    busy = run.device_s()
    if not busy or not run.steps:
        return None
    return 100.0 * run.roofline_s() / (busy / run.steps)
