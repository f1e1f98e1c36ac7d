"""`graph_share`'s reader: nothing where the port has no epoch counter (as
before the single-trial loop's CUDA graph) or counted no epoch, else the
replayed epochs' percent of all."""

from types import SimpleNamespace

import pytest

from hbench import harness
from linkpred_tpu_torch.models import twowl


@pytest.mark.parametrize("counts, share", [
    (None, None),
    ({"eager": 0, "replayed": 0, "captures": 0}, None),
    ({"eager": 4, "replayed": 0, "captures": 0}, 0.0),
    ({"eager": 1, "replayed": 399, "captures": 1}, 99.75),
], ids=["no_counter", "no_epoch", "eager_only", "replayed"])
def test_graph_share_reads_the_counter(monkeypatch, counts, share):
    if counts is None:
        monkeypatch.delattr(twowl, "EPOCH_COUNTS", raising=False)
    else:
        monkeypatch.setattr(twowl, "EPOCH_COUNTS", counts)
    got = harness.reader("graph_share.epochs").read(SimpleNamespace())
    assert got == (share if share is None else pytest.approx(share))
