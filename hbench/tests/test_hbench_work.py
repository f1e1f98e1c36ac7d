"""The yardstick's arithmetic by hand on tiny operands: bytes, operations,
least times and shares (`work.py`), the trace's interval arithmetic
(`trace.py`) and the reference's rounding (`reference/precision.py`)."""

import numpy as np
import pytest
import torch

from hbench import trace, work
from hbench.reference import precision


def test_aggregation_work_counts_inputs_once():
    # edges 0->1, 2->1, 2->0 over x [3, F=4] f32 into 2 output rows:
    # source rows {0, 2} read once, 3 edges of (index, weight), 2 rows out
    w = work.aggregation_work(np.array([0, 2, 2]), n_out=2, width=4,
                              dtype="f32")
    assert w["bytes"] == 2 * 4 * 4 + 3 * (4 + 4) + 2 * 4 * 4
    assert w["flops"] == 2 * 3 * 4
    bf = work.aggregation_work(np.array([0, 2, 2]), 2, 4, "bf16")
    assert bf["bytes"] == 2 * 4 * 2 + 3 * 8 + 2 * 4 * 2


def test_least_time_takes_the_binding_roof():
    assert work.least_seconds(3.35e12, 0, "f32") == pytest.approx(1.0)
    assert work.least_seconds(0, 67e12, "f32") == pytest.approx(1.0)
    assert work.least_seconds(0, 989e12, "bf16") == pytest.approx(1.0)
    assert work.least_seconds(3.35e12, 989e12 * 2, "bf16") == pytest.approx(2)


def test_roofline_share_sums_calls_then_divides():
    ops = [{"kernel": "k3", "bytes": 3.35e6, "flops": 0, "dtype": "f32",
            "calls": 2, "seconds": 4e-6},
           {"kernel": "k3", "bytes": 0, "flops": 0, "dtype": "f32",
            "calls": 1, "seconds": 2e-6},
           {"kernel": "k1", "bytes": 3.35e6, "flops": 0, "dtype": "f32",
            "calls": 1, "seconds": 1e-6}]
    # k3: least 2 us of bytes over 10 us spent
    assert work.roofline_share(ops, "k3") == pytest.approx(20.0)
    assert work.roofline_share(ops, "k1") == pytest.approx(100.0)
    assert work.roofline_share(ops, "k2") is None


def test_model_flops_by_hand():
    assert work.matmul_flops(2, 3, 4, batch=5) == 240
    # one node, message edge, row, slot and pair; channels 2/2, depths 1/1:
    # a forward is the 1-WL matmul 8 + its aggregation 4, the Hadamard
    # product 2, two 2-WL matmuls 16 + two directions' aggregation 8, the
    # pair product 2 and head 4: 44; an epoch is 3 x 44 (train step) + 44
    # (val forward), times the trials
    kw = dict(num_nodes=1, num_msg=1, train_rows=1, train_slots=1,
              val_rows=1, val_slots=1, batch_pairs=1, val_pairs=1,
              channels_1wl=2, channels_2wl=2, depth1=1, depth2=1)
    assert work.twowl_epoch_flops(trials=1, **kw) == 4 * 44
    assert work.twowl_epoch_flops(trials=3, **kw) == 3 * 4 * 44


def test_union_and_steps_group():
    ev = [("a", 0, 10), ("b", 5, 12), ("c", 20, 25)]
    assert trace._union(ev) == [[0, 12], [20, 25]]
    pad = trace.PAD_S * 1e6
    lead = [("lead", i, i + 1) for i in range(3)]
    steps = [("s", 2 * pad + i * 10, 2 * pad + i * 10 + 5) for i in range(5)]
    trail = [("t", 4 * pad + i, 4 * pad + i + 1) for i in range(trace.TRAIL)]
    assert trace._steps_group(lead + steps + trail) == steps
    assert trace._steps_group(lead + steps) is None


def test_tf32_rounding_by_hand():
    # 10 mantissa bits: the unit in the last place is 2^-10 in [1, 2) and
    # 2^-9 in [2, 4); a half unit rounds away from zero
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -9 - 2 ** -11, -3.0 - 2 ** -10])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         -3.0 - 2 ** -9, -3.0 - 2 ** -9])
    assert torch.equal(precision.round_tf32(x), want)
