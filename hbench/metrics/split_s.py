"""`split_s.*`: seconds of set-up's `twowl_scale.split` span, the host
build of the degree-capped graph, its split and the capped ei2 products
(`pipelines/twowl_scale.build_scale_data`)."""

from hbench import setup_spans


def read(ctx):
    return setup_spans.seconds(ctx, "twowl_scale.split")
