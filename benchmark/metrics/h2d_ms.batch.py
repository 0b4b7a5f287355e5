"""The move of a step's u8 block to the card (`Receiver.run`'s `.to`):
device time of the trace's host-to-device copies, total / steps."""


def read(run):
    return run.per_step_ms(run.device_s(("gpu_memcpy",),
                                        lambda name: "HtoD" in name))
