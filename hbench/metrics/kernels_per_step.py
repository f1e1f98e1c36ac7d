"""`kernels_per_step.*`: device operations a step (an epoch of the TwoWL
loops) in the traced stretch's profiler
capture: kernels, copies and fills, annotation ranges left out."""


def read(ctx):
    trace = ctx.trace
    if not trace or not trace["steps"]:
        return None
    return trace["device_ops"] / trace["steps"]
