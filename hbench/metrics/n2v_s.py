"""`n2v_s.*`: seconds of set-up's `twowl_scale.n2v` span, the node2vec run
(walks and SGNS on the card) and its copy into the node table
(`pipelines/twowl_scale.seed_node_table`)."""

from hbench import setup_spans


def read(ctx):
    return setup_spans.seconds(ctx, "twowl_scale.n2v")
