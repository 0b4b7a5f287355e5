"""Share of the traced window (first to last harness span) in which no
kernel, copy or fill ran on the card, from the torch.profiler trace."""


def read(run):
    return run.idle_pct()
