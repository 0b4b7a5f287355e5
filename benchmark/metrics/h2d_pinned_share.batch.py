"""Share of the step's copies onto the card that read page-locked host
memory: 100 * the program's counter `h2d.pinned` / (`h2d.pinned` +
`h2d.pageable`) (sdr_tpu_torch/io/logger.py, one of the two a copy under
the span `receiver.h2d`, kept while the trace's profiler records), in %;
None where no copy was counted or the program keeps no such counters.
The program's module is looked up among those the run loaded, not
imported here."""

import sys


def read(run):
    logger = sys.modules.get("sdr_tpu_torch.io.logger")
    if not hasattr(logger, "totals"):
        return None
    _, counters = logger.totals()
    pinned = counters.get("h2d.pinned", 0)
    copies = pinned + counters.get("h2d.pageable", 0)
    if not copies:
        return None
    return 100.0 * pinned / copies
