"""Parity of the port's sharded walks (`linkpred_tpu_torch/parallel/
walks.py`) with the JAX package's `linkpred_tpu/parallel/walks.py`, on the
CPU.

Host layouts are array-equal, dtypes included: `_reverse_edge_ids` and every
field of `TableShardedWalker.build`, on the 30-node graph of
`tests/test_parallel.py` and on fb-pages-food's residual graph. The
vectorised walker placement equals a copy of the reference's loop, and the
routing buckets a numpy loop. The walks run as 4 real gloo ranks
(`torch_ranks.walks_mesh_job`, one job for the module); their streams are
torch's, so against JAX they are compared in distribution, as the
reference's own test compares its two engines: conditional hop frequencies
within 0.12 of the JAX `WalkEngine`'s. Where the reference's count of lost
walkers is off (twice the rows really missing, ROADMAP's known faults in
the reference), the port's equals the rows really missing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from linkpred_tpu.data import io as jio
from linkpred_tpu.data import split as jsp
from linkpred_tpu.data.graph import Graph as JGraph
from linkpred_tpu.ops.walk import WalkEngine as JWalkEngine
from linkpred_tpu.parallel import make_mesh as jmake_mesh
from linkpred_tpu.parallel import walks as jwk
from linkpred_tpu_torch.data import io, split as sp
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.parallel import multihost
from linkpred_tpu_torch.parallel import walks as twk

torch.set_num_threads(1)

WORLD = 4
FREQ_ATOL = 0.12  # the reference's engine-against-engine bound


def _graph30(cls, n=30):
    """`tests/test_parallel.py::TestTableShardedWalks._graph`."""
    rng = np.random.default_rng(1234)
    pairs = np.stack([rng.integers(0, n, 120), rng.integers(0, n, 120)],
                     axis=1)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return cls.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=n)


def _fb_residual(cls, load, split):
    g, edges = load()
    keep = np.setdiff1d(np.arange(len(edges)),
                        split.removable_positive_edges(edges, g.num_nodes))
    return cls.from_undirected_edges(edges[keep, 0], edges[keep, 1],
                                     num_nodes=g.num_nodes)


GRAPHS = {
    "g30": lambda: (_graph30(Graph), _graph30(JGraph)),
    "fb": lambda: (_fb_residual(Graph, io.load_fb_pages_food, sp),
                   _fb_residual(JGraph, jio.load_fb_pages_food, jsp)),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_reverse_edge_ids_equal(name):
    g, jg = GRAPHS[name]()
    got = twk._reverse_edge_ids(g)
    ref = jwk._reverse_edge_ids(jg)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[got], np.arange(len(got)))


@pytest.mark.parametrize("drop", [0, -1], ids=["first", "last"])
def test_reverse_edge_ids_raise_on_an_asymmetric_edge_set(drop):
    """One directed edge taken away: both packages refuse (the reference
    may fail on the index before its own check, at the last edge)."""
    g, jg = GRAPHS["g30"]()
    keep = np.ones(len(g.src), bool)
    keep[drop] = False
    with pytest.raises(ValueError, match="symmetric"):
        twk._reverse_edge_ids(dataclasses.replace(g, src=g.src[keep],
                                                  dst=g.dst[keep]))
    with pytest.raises((ValueError, IndexError)):
        jwk._reverse_edge_ids(dataclasses.replace(jg, src=jg.src[keep],
                                                  dst=jg.dst[keep]))


@pytest.fixture(scope="module")
def graphs():
    return {name: make() for name, make in GRAPHS.items()}


@pytest.mark.parametrize("pq", [(1.0, 1.0), (2.0, 0.5)], ids=["p1q1",
                                                               "p2q05"])
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_equal(graphs, name, shards, pq):
    g, jg = graphs[name]
    got = twk.TableShardedWalker.build(g, shards, *pq)
    ref = jwk.TableShardedWalker.build(jg, shards, *pq)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for k in range(shards):  # a rank's shard: its rows of every field
        sh = got.shard(k)
        assert (sh.index, sh.edge_start) == (k, int(ref.edge_start[k]))
        for f in ("nbr", "degree", "indptr", "node_J", "node_q", "edge_J2",
                  "edge_q2", "rev_next"):
            np.testing.assert_array_equal(getattr(sh, f),
                                          getattr(ref, f)[k], err_msg=f)


def _place_loop(starts, owners, S, C, walk_length):
    """A copy of the reference's placement loop
    (`linkpred_tpu/parallel/walks.py:198-212`)."""
    buf = np.full((S, C, 4 + walk_length), -1, dtype=np.int32)
    fill = np.zeros(S, dtype=np.int64)
    dropped_init = 0
    for wid, (s0, o) in enumerate(zip(starts, owners)):
        i = fill[o]
        if i >= C:
            dropped_init += 1
            continue
        buf[o, i, 0] = s0  # cur
        buf[o, i, 1] = -1  # rev (-1 = first hop, node table)
        buf[o, i, 2] = 1  # alive
        buf[o, i, 3] = wid
        buf[o, i, 4] = s0  # traj[0]
        fill[o] += 1
    return buf, dropped_init


@pytest.mark.parametrize("n,num_walks,S,C", [
    (30, 4, 4, 64),  # room for all
    (30, 4, 4, 12),  # every shard overflows
    (61, 3, 8, 23),  # a short last shard, some overflow
])
def test_place_walkers_equals_the_loop(n, num_walks, S, C):
    starts = np.tile(np.arange(n, dtype=np.int32), num_walks)
    owners = starts // -(-n // S)
    got, dropped = twk._place_walkers(starts, owners, S, C, 6)
    ref, ref_dropped = _place_loop(starts, owners, S, C, 6)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype and dropped == ref_dropped


def _bucket_loop(dest, payload, cap, S):
    send = np.full((S, cap, payload.shape[1]), -1, payload.dtype)
    fill = np.zeros(S, int)
    over = np.zeros(len(dest), bool)
    for i, (d, row) in enumerate(zip(dest, payload)):
        if row[2] <= 0:
            continue  # dead rows go nowhere
        if fill[d] >= cap:
            over[i] = True
            continue
        send[d, fill[d]] = row
        fill[d] += 1
    return send, over


@pytest.mark.parametrize("cap", [3, 40])
def test_bucket_against_a_loop(cap):
    rng = np.random.default_rng(cap)
    C, S = 50, 4
    payload = rng.integers(0, 100, (C, 9)).astype(np.int32)
    payload[:, 2] = rng.random(C) < 0.8  # some dead rows
    payload[:, 2][payload[:, 2] == 0] = -1
    dest = rng.integers(0, S, C)
    send, over = twk._bucket(torch.as_tensor(dest), torch.as_tensor(payload),
                             cap, S)
    ref, ref_over = _bucket_loop(dest, payload, cap, S)
    np.testing.assert_array_equal(send.numpy(), ref)
    np.testing.assert_array_equal(over.numpy(), ref_over)
    assert ref_over.any() == (cap == 3)


# ---------------------------------------------------------------------------
# over 4 gloo ranks
# ---------------------------------------------------------------------------

CAP = 3  # a forced capacity per destination, far below the default


@pytest.fixture(scope="module")
def walk_runs(graphs, tmp_path_factory):
    g = graphs["g30"][0]
    biased = twk.TableShardedWalker.build(g, WORLD, p=2.0, q=0.5)
    cases = {
        "edge4": ("routed", (biased, (WORLD,), ("edge",), 0, 60, 10, None)),
        "mesh22": ("routed", (twk.TableShardedWalker.build(g, 2, p=2.0,
                                                           q=0.5),
                              (2, 2), ("data", "edge"), 0, 60, 10, None)),
        "forced": ("routed", (twk.TableShardedWalker.build(g, WORLD),
                              (WORLD,), ("edge",), 0, 4, 6, CAP)),
        "sharded4": ("sharded", (g, (WORLD,), ("data",), 0, 3, 8)),
        "sharded22": ("sharded", (g, (2, 2), ("data", "edge"), 0, 3, 8)),
    }
    return multihost.launch(torch_ranks.walks_mesh_job, WORLD,
                            str(tmp_path_factory.mktemp("walks")),
                            args=(cases,))


def _valid_hops(walks, g):
    has = g.has_edge_matrix()
    a, b = walks[:, :-1].reshape(-1), walks[:, 1:].reshape(-1)
    stall = (a == b) & (g.degree[a] == 0)
    return bool((has[a, b] | stall).all())


def _cond_freq(walks, n):
    a, b = walks[:, :-1].reshape(-1), walks[:, 1:].reshape(-1)
    moved = a != b
    c = np.zeros((n, n))
    np.add.at(c, (a[moved], b[moved]), 1)
    tot = c.sum(axis=1, keepdims=True)
    tot[tot == 0] = 1
    return c / tot


@pytest.mark.parametrize("case", ["edge4", "mesh22"])
def test_routed_walks_match_the_jax_engine(graphs, walk_runs, case):
    """No walker lost, row r * N + v starts at v, every hop an edge, and
    the conditional hop frequencies at p = 2, q = 0.5 within 0.12 of the
    JAX `WalkEngine`'s (as `TestTableShardedWalks` holds the reference's
    two engines)."""
    g, jg = graphs["g30"]
    n = g.num_nodes
    walks, lost = walk_runs[0][case]
    assert lost == 0
    assert walks.shape == (60 * n, 10) and walks.dtype == np.int32
    np.testing.assert_array_equal(walks[:, 0], np.tile(np.arange(n), 60))
    assert _valid_hops(walks, g)
    ref = np.asarray(JWalkEngine(jg, p=2.0, q=0.5).walks(
        jax.random.PRNGKey(1), 60, 10))
    diff = np.abs(_cond_freq(walks, n) - _cond_freq(ref, n))
    assert diff.max() < FREQ_ATOL, diff.max()
    for r in walk_runs[1:]:  # every rank returns the whole matrix
        np.testing.assert_array_equal(r[case][0], walks)


def test_lost_counts_each_missing_walker_once(graphs, walk_runs):
    """At a forced capacity the port's `lost` is the number of rows that
    came back empty; the reference reports twice its own empty rows."""
    g, jg = graphs["g30"]
    n, total = g.num_nodes, 4 * g.num_nodes
    assert g.degree[0] > 0  # so a walk from node 0 is never all zeros
    walks, lost = walk_runs[0]["forced"]
    missing = int((walks == 0).all(axis=1).sum())
    assert 0 < lost == missing < total
    kept = ~(walks == 0).all(axis=1)
    np.testing.assert_array_equal(walks[kept, 0],
                                  np.tile(np.arange(n), 4)[kept])
    assert _valid_hops(walks[kept], g)
    jmesh = jmake_mesh(WORLD, axis_names=("edge",), shape=(WORLD,))
    jw, jlost = jwk.TableShardedWalker.build(jg, WORLD).walks(
        jmesh, jax.random.PRNGKey(0), 4, 6, capacity_per_dest=CAP)
    jmissing = int((np.asarray(jw) == 0).all(axis=1).sum())
    assert jmissing > 0 and jlost == 2 * jmissing


@pytest.mark.parametrize("case", ["sharded4", "sharded22"])
def test_sharded_walks_shape_and_hops(graphs, walk_runs, case):
    g = graphs["g30"][0]
    n = g.num_nodes
    walks, _ = walk_runs[0][case]
    assert walks.shape == (3 * n, 8) and walks.dtype == np.int32
    np.testing.assert_array_equal(walks[:, 0], np.tile(np.arange(n), 3))
    assert _valid_hops(walks, g)
    for r in walk_runs[1:]:
        np.testing.assert_array_equal(r[case][0], walks)


def test_ranks_load_no_jax(walk_runs):
    assert [r["jax_modules"] for r in walk_runs] == [[]] * WORLD
