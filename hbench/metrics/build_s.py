"""`build_s`: seconds of the port's host build and layout (the pipeline's
data build and the ops' operands), on the host's clock around those calls
in the harness."""


def read(ctx):
    return ctx.build_s
