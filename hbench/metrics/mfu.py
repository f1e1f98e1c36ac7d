"""`mfu.*`: percent of the card's peak for the step's dtype (`work.
PEAK_FLOP_PER_S`) that the model FLOPs of a step (`work.twowl_epoch_flops`) times the steps a second of the traced run's
untraced stretch make up."""

from hbench import work


def read(ctx):
    if not ctx.flops_per_step or not ctx.steps_per_s:
        return None
    return (100.0 * ctx.flops_per_step * ctx.steps_per_s
            / work.PEAK_FLOP_PER_S[ctx.flops_dtype])
