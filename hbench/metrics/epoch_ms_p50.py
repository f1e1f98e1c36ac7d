"""`epoch_ms_p50.*`: the median card ms between the port's epoch events
(`utils/profiling.mark_step` at each `twowl.epoch`'s start and the loop's
end) over the span stretch's epochs."""

from hbench import spans


def read(ctx):
    t = spans.epoch_tail(ctx)
    return t[0] if t else None
