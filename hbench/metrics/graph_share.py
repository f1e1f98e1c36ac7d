"""`graph_share.*`: percent of the epochs of the port's single-trial loop
(`models/twowl.train_loop`) in this process that ran as one replay of the
epoch's CUDA graph, from the port's counter `EPOCH_COUNTS`: replayed epochs
over replayed and eager ones. Nothing where the port has no such counter or
ran no epoch."""


def read(ctx):
    from linkpred_tpu_torch.models import twowl

    counts = getattr(twowl, "EPOCH_COUNTS", None)
    if not counts:
        return None
    epochs = counts["replayed"] + counts["eager"]
    return 100.0 * counts["replayed"] / epochs if epochs else None
