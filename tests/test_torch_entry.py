"""The port's entry point (`linkpred_tpu_torch.graft_entry.entry`) against the
JAX package's `__graft_entry__.entry()` on the CPU: the same toy graph,
array for array, and from the same parameters (carried across with
`models/twowl.params_from_jax`) the same LocalWLNet scores to rtol/atol
1e-5, on the plain aggregation and on the kernels' plain versions. Both
packages draw the toy graph's negatives with the numpy sampler here, so the
test does not depend on a compiler."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from linkpred_tpu import native as jnative
from linkpred_tpu_torch import graft_entry as tentry
from linkpred_tpu_torch import native as tnative
from linkpred_tpu_torch.models import twowl as tm

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def numpy_sampler(monkeypatch):
    monkeypatch.setattr(jnative, "load_library", lambda: None)
    monkeypatch.setattr(tnative, "load_library", lambda: None)


def _assert_equal(a, b, path="data"):
    """Dataclass trees of arrays and scalars, equal field for field."""
    if dataclasses.is_dataclass(a):
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], path
        for n in names:
            _assert_equal(getattr(a, n), getattr(b, n), f"{path}.{n}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_toy_data_equals_jax():
    _assert_equal(tentry._toy_twowl_data(), jentry._toy_twowl_data())


@pytest.mark.parametrize("agg", ["plan", "ell"])
def test_entry_forward_matches_jax(agg):
    fn_j, (pj, deg_j, arrays_j) = jentry.entry()
    ref = np.asarray(fn_j(pj, deg_j, arrays_j))
    fn_t, (pt, deg_t, arrays_t) = tentry.entry(device="cpu", agg_1wl=agg)
    assert deg_t.device.type == "cpu" and tm.tree_leaves(pt)[0].is_cuda is False
    shared = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    got = fn_t(shared, deg_t, arrays_t)
    # one score per pair: the split's prediction rows hold both directions
    assert got.shape == ref.shape == (
        (arrays_t.num_rows - arrays_t.num_msg) // 2,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the port's own init: a valid forward of the same shape
    own = fn_t(pt, deg_t, arrays_t)
    assert own.shape == got.shape and torch.isfinite(own).all()


def test_entry_config_is_the_jax_one():
    """channels 16/8, depths 2/2 on the toy graph's degree cap: the
    parameter trees have the same shapes leaf for leaf."""
    _, (pj, _, _) = jentry.entry()
    _, (pt, _, _) = tentry.entry(device="cpu")
    shared = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")

    def shapes(tree):
        return tm.tree_map(lambda t: tuple(t.shape), tree)

    assert shapes(pt) == shapes(shared)
    assert len(shared["conv1"]) == 2 and len(shared["conv2"]) == 2
    assert shapes(shared)["conv1"][0]["w"] == (16, 16)
    assert shapes(shared)["conv2"][0]["w"] == (8, 8)
