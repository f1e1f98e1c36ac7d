"""Parity of the port's halo exchange (`linkpred_tpu_torch.parallel.halo`)
with the JAX package's `linkpred_tpu.parallel.halo`, on the CPU.

The host layout — the label-propagation clusters, the four orderings, the
hub rules, every field of `HaloLayout` — is array-equal to the reference's.
`spmm_halo` and `spmm_halo_sym` run as 2 and 4 gloo ranks (rank bodies in
`tests/torch_ranks.py`, which imports no JAX) against the JAX package's on
a mesh of as many virtual CPU devices: forward and gradient to rtol 1e-5
(f32 sums in another order), with and without hubs, and with the exchange
compressed to bf16 (both round the same boundary rows once).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from benchmarks.scaling import synth_community_graph as jcommunity
from benchmarks.scaling import synth_powerlaw_graph as jpowerlaw
from linkpred_tpu.data.graph import Graph as JGraph
from linkpred_tpu.parallel import halo as jh
from linkpred_tpu.parallel.mesh import make_mesh as jmake_mesh
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.data.synth import (synth_community_graph,
                                           synth_powerlaw_graph)
from linkpred_tpu_torch.parallel import halo as th
from linkpred_tpu_torch.parallel import multihost

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
FIELDS = ("num_nodes", "n_shards", "rows_per_shard", "ghost_capacity",
          "order", "inv_perm", "send_idx", "pad_rows", "edge_cut",
          "hub_capacity", "hub_send", "num_hubs", "out_inv")


def _sym(cls, lo, hi, n):
    g = cls.from_undirected_edges(lo, hi, num_nodes=n)
    d = np.asarray(g.degree, np.float64) + 1.0
    inv = (1.0 / np.sqrt(d)).astype(np.float32)
    w = inv[:, None] * inv[np.asarray(g.nbr)]
    return dataclasses.replace(g, nbr_weight=np.ascontiguousarray(w))


def _random(cls, n=400, e=1600, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = lo != hi
    return _sym(cls, lo[keep], hi[keep], n)


def _hubby(cls, n_base=1000, n_hubs=150, hub_deg=24):
    """`tests/test_halo.py`'s community graph with global hubs, smaller."""
    synth = synth_community_graph if cls is Graph else jcommunity
    lo, hi = synth(n_base, 4 * n_base, n_comm=16, seed=3)
    rng = np.random.default_rng(4)
    hub_u = np.repeat(np.arange(n_base, n_base + n_hubs), hub_deg)
    hub_v = rng.integers(0, n_base, len(hub_u))
    return _sym(cls, np.concatenate([lo, np.minimum(hub_u, hub_v)]),
                np.concatenate([hi, np.maximum(hub_u, hub_v)]),
                n_base + n_hubs)


def _powerlaw(cls, n=300):
    synth = synth_powerlaw_graph if cls is Graph else jpowerlaw
    lo, hi = synth(n, 1500, seed=5)
    return _sym(cls, lo, hi, n)


def _assert_layouts_equal(got, ref):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    assert len(got.stacked) == len(ref.stacked)
    for a, b in zip(got.stacked, ref.stacked):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for feats, nbytes in ((128, 4), (64, 2)):
        assert (got.collective_bytes_per_layer(feats, nbytes)
                == ref.collective_bytes_per_layer(feats, nbytes))


# ---------------------------------------------------------------------------
# host: the partitioner and the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", ["random", "hubby"])
def test_label_prop_clusters_equal(graph):
    make = _random if graph == "random" else _hubby
    g, gj = make(Graph), make(JGraph)
    for seed in (0, 3):
        np.testing.assert_array_equal(
            th._label_prop_clusters(g.src, g.dst, g.num_nodes, seed=seed),
            jh._label_prop_clusters(gj.src, gj.dst, gj.num_nodes, seed=seed))


@pytest.mark.parametrize("reorder", [True, "cluster", "rcm", "balance",
                                     False])
def test_halo_layout_equal_each_ordering(reorder):
    _assert_layouts_equal(th.HaloLayout.build(_hubby(Graph), 4, reorder),
                          jh.HaloLayout.build(_hubby(JGraph), 4, reorder))


@pytest.mark.parametrize("hubs", [None, 2, 3, "budget"])
def test_halo_layout_equal_hub_rules(hubs):
    """Hubs off, forced at 2 and 3 readers (the ownership re-deal runs),
    and capped by a budget."""
    kw = (dict(hub_min_refs=2, hub_budget=40) if hubs == "budget"
          else dict(hub_min_refs=hubs))
    got = th.HaloLayout.build(_hubby(Graph), 8, "cluster", **kw)
    _assert_layouts_equal(got, jh.HaloLayout.build(_hubby(JGraph), 8,
                                                   "cluster", **kw))
    if hubs is not None:
        assert got.num_hubs > 0


def test_halo_layout_equal_random_graph_auto():
    _assert_layouts_equal(th.HaloLayout.build(_random(Graph), 8),
                          jh.HaloLayout.build(_random(JGraph), 8))


# ---------------------------------------------------------------------------
# spmm_halo and spmm_halo_sym, forward and gradient
# ---------------------------------------------------------------------------


def _cases():
    """name -> (graph builder, build kwargs, exchange dtype)."""
    return {
        "auto": (_random, dict(), None),
        "input_order": (_random, dict(reorder=False), None),
        # forced at one other reader: with 2 shards no row has two
        "hubs": (_powerlaw, dict(hub_min_refs=1), None),
        "bf16_exchange": (_random, dict(), "bfloat16"),
    }


@functools.cache
def _inputs():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((400, 8)).astype(np.float32),
            rng.standard_normal((400, 8)).astype(np.float32))


@functools.cache
def _jax_refs(world):
    """The JAX package's `spmm_halo` and the gradient of `spmm_halo_sym` of
    each case over `world` devices, on its own layouts (jitted; its inputs
    relabelled and padded to `rows_per_shard * world` rows)."""
    x_all, t_all = _inputs()
    mesh = jmake_mesh(n_devices=world, shape=(1, world))
    out = {}
    for name, (make, kw, xd) in _cases().items():
        g = make(JGraph)
        lay = jh.HaloLayout.build(g, world, **kw)
        n, pad = g.num_nodes, lay.rows_per_shard * world
        ops = lay.operands()
        xdt = getattr(jnp, xd) if xd else None
        x = jnp.asarray(np.pad(x_all[:n][lay.order], ((0, pad - n), (0, 0))))
        t = jnp.asarray(t_all[:n][lay.order])

        def fwd(xx, lay=lay, ops=ops, xdt=xdt):
            return jh.spmm_halo(mesh, xx, lay.num_nodes, lay.rows_per_shard,
                                lay.ghost_capacity, *ops, exchange_dtype=xdt)

        def loss(xx, lay=lay, ops=ops, t=t):
            return jnp.sum(jh.spmm_halo_sym(
                mesh, xx, lay.num_nodes, lay.rows_per_shard,
                lay.ghost_capacity, ops) * t)

        out[name] = np.asarray(jax.jit(fwd)(x))
        if xd is None:
            out[name + "_grad"] = np.asarray(jax.jit(jax.grad(loss))(x))
    return out


@pytest.fixture(scope="module", params=[2, 4])
def halo_runs(request, tmp_path_factory):
    world = request.param
    layouts = {name: (th.HaloLayout.build(make(Graph), world, **kw), xd)
               for name, (make, kw, xd) in _cases().items()}
    got = multihost.launch(torch_ranks.halo_job, world,
                           str(tmp_path_factory.mktemp("halo")),
                           args=(layouts, *_inputs()))
    return world, layouts, got


@pytest.mark.parametrize("case", ["auto", "input_order", "hubs"])
def test_spmm_halo_matches_jax(halo_runs, case):
    world, layouts, got = halo_runs
    ref = _jax_refs(world)
    out = got[0][0]
    np.testing.assert_allclose(out[case], ref[case], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[case + "_sym"], ref[case], rtol=RTOL,
                               atol=ATOL)
    if case == "hubs":
        assert layouts[case][0].num_hubs > 0


@pytest.mark.parametrize("case", ["auto", "input_order", "hubs"])
def test_spmm_halo_sym_grad_matches_jax(halo_runs, case):
    """The gradient of a pre-padded [rows * S, F] input, as the reference
    takes it: its shape, zero on the padding rows, and equal to the JAX
    package's custom VJP."""
    world, layouts, got = halo_runs
    out, lay = got[0][0], layouts[case][0]
    grad = out[case + "_grad"]
    assert grad.shape == (lay.rows_per_shard * world, 8)
    np.testing.assert_allclose(grad, _jax_refs(world)[case + "_grad"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(grad[lay.num_nodes:], 0.0)


def test_spmm_halo_bf16_exchange_matches_jax(halo_runs):
    world, _, got = halo_runs
    ref = _jax_refs(world)["bf16_exchange"]
    out = got[0][0]
    np.testing.assert_allclose(out["bf16_exchange"], ref, rtol=RTOL,
                               atol=ATOL)
    # it rounds the ghost rows: not the f32 exchange's result
    assert np.abs(out["bf16_exchange"] - out["auto"]).max() > 1e-4


def test_spmm_halo_short_block_keeps_its_rows(halo_runs):
    world, layouts, got = halo_runs
    for name, (lay, _) in layouts.items():
        assert got[0][0][name + "_short"] == (lay.rows_per_shard - 1, 8)


def test_halo_ranks_load_no_jax(halo_runs):
    _, _, got = halo_runs
    assert [r[1] for r in got] == [[]] * len(got)
