"""Host enqueue of a block: the harness's clock from the call into
`Receiver.run` to its return (before any wait for the card), total over
the window's blocks / blocks."""


def read(run):
    return run.span_ms("enqueue")
