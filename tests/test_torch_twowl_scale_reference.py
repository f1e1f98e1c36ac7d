"""TwoWL at scale in the port (`pipelines/twowl_scale.py`, the benchmark's
`twowl-50k` configuration) against the benchmark's plain reference
(`hbench/reference/twowl_scale.py`), on the CPU at the cell's small size
(`hbench/small/twowl-50k.train.json`: 2,000 nodes and 20,000 edges drawn,
the published widths, the degree and ei2 caps, the bf16 2-WL stack): the
port's host build is the reference's, its first three epochs agree with the
reference within the cell's limits while the float8 control fails one, its
node2vec table stands beside the reference's own while a table cut short
fails a limit, and the scale path's set-up spans open while recording and
cost nothing off."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from hbench import check, harness  # noqa: E402
from hbench.drivers import twowl  # noqa: E402
from hbench.reference import twowl_scale as scale_ref  # noqa: E402
from hbench.reference.twowl import tree_like  # noqa: E402
from linkpred_tpu_torch.models import twowl as m  # noqa: E402
from linkpred_tpu_torch.pipelines import twowl_scale as ts  # noqa: E402
from linkpred_tpu_torch.utils import profiling  # noqa: E402

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

CELL = "twowl-50k.train"
CPU = torch.device("cpu")
SEED = 3000000021


def sized():
    """The cell's configuration and traffic at its small size."""
    cell = harness.workload(harness.load_spec(), CELL)
    config, traffic = harness.small(CELL)
    return ({**harness.load_data("configs", cell["config"]), **config},
            {**harness.load_data("traffic", cell["traffic"]), **traffic})


@pytest.fixture(scope="module")
def started():
    """A seeded run at the small size: the port's build, its first three
    epochs (kept for the check) and a warm chunk."""
    config, traffic = sized()
    drv = harness.driver(config)
    built = drv.build(config, traffic, CPU)
    return drv, drv.start(built, config, traffic, SEED, CPU)


def test_the_reference_rounds_as_bfloat16_does():
    x = torch.randn(4096) * torch.exp(4 * torch.randn(4096))
    assert torch.equal(scale_ref.round_mantissa(x, 7),
                       x.to(torch.bfloat16).float())
    # 3 mantissa bits: a half unit (2^-4 in [1, 2)) rounds to even
    y = torch.tensor([1.0625, 1.1875, 1.0 + 2 ** -4 + 2 ** -6, -3.3])
    assert torch.equal(scale_ref.round_mantissa(y, 3),
                       torch.tensor([1.0, 1.25, 1.125, -3.25]))


def _drop_first(a):
    return a[1:]


def _swap_first_two(a):
    a = a.copy()
    a[[0, 1]] = a[[1, 0]]
    return a


@pytest.mark.parametrize("plant", [
    None,
    ("train", "msg", _swap_first_two),
    ("val", "e1_mask", lambda a: np.where(np.arange(len(a)) == 0, False, a)),
    ("train", "pred", _drop_first),
], ids=["sound", "message_edges", "ei2_product", "train_negatives"])
def test_host_build_equals_the_reference(started, plant):
    """`build` counts no fault in the port's build; a build with a fault
    planted (message edges out of order, one ei2 product lost, a train
    negative lost) counts one or more."""
    drv, run = started
    built = dict(run.built)
    if plant is not None:
        split, field, change = plant
        data = built["data"]
        s = getattr(data, split)
        s = dataclasses.replace(s, **{field: change(getattr(s, field))})
        built["data"] = dataclasses.replace(data, **{split: s})
    faults = drv.build_faults(built, drv.reference_data(built))
    assert (faults == 0) == (plant is None), faults


@pytest.mark.parametrize("precision", [None, "e4m3"],
                         ids=["program", "float8_control"])
def test_first_three_epochs_against_the_reference(started, precision):
    """The program's first three epochs (eager, as on the CPU every epoch
    is) lie within every limit of the cell; the reference with the 2-WL
    stack's tensors at float8 e4m3's mantissa in the program's place
    fails at least one."""
    drv, run = started
    judged = check.judge(drv.readings(run, control_precision=precision),
                         harness.load_data("limits", CELL))
    over = [(k, v, lim) for k, v, lim in judged if v > lim]
    if precision is None:
        assert not over, judged
    else:
        assert over, judged


def _cut_table(run, cut):
    """The node table of a node2vec run cut short: left at its init
    (node2vec skipped), SGNS at half its epochs, or half the walks."""
    cfg, data = run.built["cfg"], run.built["data"]
    init_seed, n2v_seed, _, _ = twowl._seeds(SEED)
    if cut == "table_at_init":
        return m.init_params(run.cfg, torch.Generator().manual_seed(
            init_seed), CPU)["emb"]
    field = {"sgns_epochs_halved": "n2v_epochs",
             "walks_halved": "n2v_walks_per_node"}[cut]
    cut_cfg = dataclasses.replace(cfg, **{field: getattr(cfg, field) // 2})
    return ts.n2v_embeddings(cut_cfg, data, CPU, n2v_seed)


@pytest.mark.parametrize("cut", [
    None, "table_at_init", "sgns_epochs_halved", "walks_halved"])
def test_node2vec_table_against_the_reference(started, cut):
    """The program's node2vec table (the start of its three epochs) lies
    within the cell's `n2v_auc` and `n2v_norm` limits against the
    reference's own node2vec run; a table cut short fails one of them."""
    drv, run = started
    table = (tree_like(run.layout, run.snapshot["start"])["emb"]
             if cut is None else _cut_table(run, cut))
    assert table.shape == (run.built["num_nodes"],
                           run.config["model"]["channels_1wl"])
    readings = drv.n2v_readings(run.reference_data(), run.reference_table(),
                                table)
    limits = harness.load_data("limits", CELL)
    over = [k for k, v in readings.items() if v > limits[k]]
    assert bool(over) == (cut is not None), (readings, limits)


def _setup_calls(config, traffic):
    cfg = harness.driver(config).scale_config(config, traffic)
    data = ts.build_scale_data(cfg)
    arrays = ts.split_operands(data, CPU)
    params = m.init_params(ts.model_config(cfg, data),
                           torch.Generator().manual_seed(0), CPU)
    ts.seed_node_table(cfg, data, params, CPU, 1)
    return data, arrays, params


@pytest.mark.parametrize("recording", [True, False], ids=["on", "off"])
def test_setup_spans(monkeypatch, recording):
    """On: the split build, the operands and the node2vec seeding are one
    span each, in that order, none inside another. Off: the same calls read
    no clock and record nothing."""
    config, traffic = sized()
    if recording:
        with profiling.recording() as rec:
            data, _, params = _setup_calls(config, traffic)
        assert [s.name for s in rec.spans] == [
            "twowl_scale.split", "twowl_scale.operands", "twowl_scale.n2v"]
        assert all(s.parent is None and s.end_ns > s.start_ns
                   for s in rec.spans)
    else:
        def refuse(*args, **kwargs):
            raise AssertionError("a clock read while recording is off")

        monkeypatch.setattr(profiling, "_clock", refuse)
        data, _, params = _setup_calls(config, traffic)
    assert params["emb"].shape == (data.num_nodes, config["model"][
        "channels_1wl"])
