"""`idle_share.*`: percent of the traced stretch's device window in which
no operation ran on the card: 1 less the union of the operations' intervals
over the span from the first one's start to the last one's end, from that
window's own timeline."""


def read(ctx):
    trace = ctx.trace
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
