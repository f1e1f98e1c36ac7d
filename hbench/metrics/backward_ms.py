"""`backward_ms.*`: the median self ms of the `twowl.backward` span (the
train step's `loss.backward()`, `models/twowl.train_step`) over the span
stretch's epochs."""

from hbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "twowl.backward")
