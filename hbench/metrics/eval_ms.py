"""`eval_ms.*`: the median self ms of the `twowl.eval` span (the val
forward, its AUC and the best-val select, `models/twowl.train_loop`) over
the span stretch's epochs."""

from hbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "twowl.eval")
