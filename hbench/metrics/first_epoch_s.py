"""`first_epoch_s.*`: seconds of set-up's first `twowl.epoch` span, the
first checked epoch: the kernels' loads and every first call's cost."""

from hbench import spans


def read(ctx):
    return spans.first_epoch_s(ctx)
