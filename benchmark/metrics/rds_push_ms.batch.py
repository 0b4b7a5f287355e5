"""Host RDS decode of a step: `MultiStreamingRds.push` over every station
by the harness's clock, total over the window's steps / steps."""


def read(run):
    return run.span_ms("rds_push")
