"""`optimizer_ms.*`: the median self ms of the `twowl.optimizer` span (the
train step's Adam step and `zero_grad`, `models/twowl.train_step`) over the
span stretch's epochs."""

from hbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "twowl.optimizer")
