"""`kernel_load_s.*`: seconds of the `kernels.load` spans in set-up (the
port's `kernels/build.library` on each source's first load, an `nvcc` run
included where the library had to be built)."""

from hbench import spans


def read(ctx):
    return spans.kernel_load_s(ctx)
