"""The conv engine's device time a step (`PolyphaseResampler`, `MultiFIR`
in ops/resample.py): the cuDNN convolution kernels, by name, and the
concatenations and casts that feed each one (the kernels launched between
the step's previous other kernel and the convolution), total / steps."""

CONV = ("conv", "xmma", "cudnn", "implicit_gemm", "fprop")
FEED = ("CatArrayBatchedCopy", "copy_kernel", "direct_copy")


def _is(name, parts):
    return any(p in name for p in parts)


def read(run):
    kernels = sorted((ts, name, dur) for cat, name, ts, dur
                     in run.device_events if cat == "kernel")
    total, feed, seen = 0.0, [], False
    for _, name, dur in kernels:
        if _is(name, CONV) and not _is(name, FEED):
            total += dur + sum(feed)
            feed, seen = [], True
        elif _is(name, FEED):
            feed.append(dur)
        else:
            feed = []
    return run.per_step_ms(total * 1e-6) if seen else None
