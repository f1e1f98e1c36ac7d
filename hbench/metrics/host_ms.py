"""`host_ms.*`: the median host ms of a `twowl.epoch` span (the port's
`models/twowl.train_loop`, one span an epoch) over the span stretch's
epochs (`spans.stretch`)."""

from hbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "twowl.epoch", own=False)
