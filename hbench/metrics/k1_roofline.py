"""`k1_roofline.*`: percent of its roofline that K1 reaches over the
step's K1 calls at the cell's operands (`work.roofline_share`): the least
time of their bytes and operations over their CUDA-event times. Nothing
when the cell's step makes no K1 call."""

from hbench import work


def read(ctx):
    return work.roofline_share(ctx.ops, "k1")
