"""Host RDS frame sync of a step (`StreamingRdsDecoder._advance_sync` and
the station info, every station): the program's span `rds.framing`
(sdr_tpu_torch/io/logger.py, kept while the trace's profiler records),
total / the count of `receiver.run` (one a step), in ms; None where the
span never ran or the program keeps no spans.  The program's module is
looked up among those the run loaded, not imported here."""

import sys


def read(run):
    logger = sys.modules.get("sdr_tpu_torch.io.logger")
    if not hasattr(logger, "totals"):
        return None
    spans, _ = logger.totals()
    if "rds.framing" not in spans or "receiver.run" not in spans:
        return None
    return spans["rds.framing"][0] / spans["receiver.run"][1] * 1e3
