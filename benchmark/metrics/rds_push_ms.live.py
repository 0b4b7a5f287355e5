"""Host RDS decode of a block: `StreamingRdsDecoder.push` by the harness's
clock, total over the window's blocks / blocks."""


def read(run):
    return run.span_ms("rds_push")
