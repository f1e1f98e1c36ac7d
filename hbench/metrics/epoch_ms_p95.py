"""`epoch_ms_p95.*`: the 95th percentile of the card ms between the port's
epoch events (`utils/profiling.mark_step`) over the span stretch's epochs,
200 samples or more."""

from hbench import spans


def read(ctx):
    t = spans.epoch_tail(ctx)
    return t[1] if t else None
