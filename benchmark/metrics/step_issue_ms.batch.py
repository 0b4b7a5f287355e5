"""Host time of `Receiver.step` on a step (the issue of its kernels): the
program's span `receiver.step` (sdr_tpu_torch/io/logger.py, kept while
the trace's profiler records), total / the count of `receiver.run` (one
a step), in ms; None where the span never ran or the program keeps no
spans.  The program's module is looked up among those the run loaded,
not imported here."""

import sys


def read(run):
    logger = sys.modules.get("sdr_tpu_torch.io.logger")
    if not hasattr(logger, "totals"):
        return None
    spans, _ = logger.totals()
    if "receiver.step" not in spans or "receiver.run" not in spans:
        return None
    return spans["receiver.step"][0] / spans["receiver.run"][1] * 1e3
