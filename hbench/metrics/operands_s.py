"""`operands_s.*`: seconds of set-up's `twowl_scale.operands` span, the
train and val splits' device operands: plans, K1's slot matrix and K3's
composed layouts, built on the host and uploaded
(`pipelines/twowl_scale.split_operands`)."""

from hbench import setup_spans


def read(ctx):
    return setup_spans.seconds(ctx, "twowl_scale.operands")
