"""Share of the 104-bit windows the host RDS decoder's frame sync tested
that yielded a group: 100 * the program's counter `rds.groups` / its
counter `rds.windows` (sdr_tpu_torch/io/logger.py, kept while the trace's
profiler records), in %; None where no window was tested or the program
keeps no counters.  The program's module is looked up among those the
run loaded, not imported here."""

import sys


def read(run):
    logger = sys.modules.get("sdr_tpu_torch.io.logger")
    if not hasattr(logger, "totals"):
        return None
    _, counters = logger.totals()
    if not counters.get("rds.windows"):
        return None
    return 100.0 * counters.get("rds.groups", 0) / counters["rds.windows"]
