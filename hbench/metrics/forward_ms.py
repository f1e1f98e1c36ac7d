"""`forward_ms.*`: the median self ms of the `twowl.forward` span (the
train step's forward and BCE loss, `models/twowl.train_step`) over the span
stretch's epochs."""

from hbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "twowl.forward")
