"""Kernel time of a step on the card (hand-written kernels and the torch
and cuDNN ops around them): device time of the trace's kernels, total /
steps."""


def read(run):
    return run.per_step_ms(run.device_s())
