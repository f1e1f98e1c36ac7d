"""Parity of the port's node2vec walks (`linkpred_tpu_torch/ops/walk.py`)
with the JAX package's, on the CPU.

The host-side tables are held array-equal. The walk itself draws from torch's
random stream, so it is compared exactly only where no draw matters (every
node with out-degree 1) and else in distribution: the second-order return
frequency within 3 sigma of the JAX engine's on the same fixture.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linkpred_tpu.data.graph import Graph as JGraph
from linkpred_tpu.ops import walk as jw
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.ops import walk as tw

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)


def _random_graph(seed, n=40, e=140, weighted=False):
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = u != v
    u, v = u[keep], v[keep]
    if not weighted:
        return (Graph.from_undirected_edges(u, v, num_nodes=n),
                JGraph.from_undirected_edges(u, v, num_nodes=n))
    w = rng.uniform(0.5, 3.0, len(u)).astype(np.float32)
    src, dst, ww = (np.concatenate(p) for p in ((u, v), (v, u), (w, w)))
    return (Graph.from_edges(src, dst, num_nodes=n, weight=ww),
            JGraph.from_edges(src, dst, num_nodes=n, weight=ww))


def _tables_on(tab, g):
    put = torch.as_tensor
    return (put(g.nbr), put(g.indptr[:-1]), put(g.degree), put(tab.node_J),
            put(tab.node_q), put(tab.edge_J), put(tab.edge_q))


def test_alias_setup_rows_equal():
    rng = np.random.default_rng(0)
    probs = rng.random((30, 9))
    valid = np.arange(9)[None, :] < rng.integers(0, 10, 30)[:, None]
    probs[3] = 0.0  # a row whose probabilities sum to 0 falls back to uniform
    for got, ref in zip(tw.alias_setup_rows(probs, valid),
                        jw.alias_setup_rows(probs, valid)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.25, 4.0)])
@pytest.mark.parametrize("weighted", [False, True])
def test_alias_tables_equal(p, q, weighted):
    gt, gj = _random_graph(1, weighted=weighted)
    got, ref = tw.AliasTables.build(gt, p=p, q=q), jw.AliasTables.build(
        gj, p=p, q=q)
    for name in ("node_J", "node_q", "edge_J", "edge_q"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_walks_shape_starts_and_validity():
    gt, _ = _random_graph(2, n=30, e=80)
    eng = tw.WalkEngine(gt, device="cpu")
    walks = eng.walks(torch.Generator().manual_seed(0), num_walks=3,
                      walk_length=10)
    assert walks.shape == (90, 10) and walks.dtype == torch.int32
    walks = walks.numpy()
    np.testing.assert_array_equal(walks[:, 0], np.tile(np.arange(30), 3))
    has = gt.has_edge_matrix()
    for w in walks:
        for a, b in zip(w[:-1], w[1:]):
            assert has[a, b] or (a == b and gt.degree[a] == 0)


def test_degree_one_walks_equal_jax():
    """A directed cycle with a tail into it and a dead end: every node has
    out-degree 1 or 0, so no draw matters and both engines must agree."""
    src = np.array([0, 1, 2, 3, 4, 5])
    dst = np.array([1, 2, 3, 0, 0, 6])  # 6 has no out-edge
    gt = Graph.from_edges(src, dst, num_nodes=7)
    gj = JGraph.from_edges(src, dst, num_nodes=7)
    starts = np.arange(7, dtype=np.int32)
    tab = tw.AliasTables.build(gt)
    got = tw.simulate_walks(torch.Generator().manual_seed(3),
                            torch.as_tensor(starts), *_tables_on(tab, gt), 9)
    jtab = jw.AliasTables.build(gj)
    ref = jw.simulate_walks(
        jax.random.PRNGKey(0), jnp.asarray(starts), jnp.asarray(gj.nbr),
        jnp.asarray(gj.indptr[:-1]), jnp.asarray(gj.degree),
        jnp.asarray(jtab.node_J), jnp.asarray(jtab.node_q),
        jnp.asarray(jtab.edge_J), jnp.asarray(jtab.edge_q), walk_length=9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[6] == 6).all() and (got[5, 1:] == 6).all()


def test_second_order_bias_matches_jax():
    """The triangle 0-1-2: from the hop 0 -> 1, a small p favours the return
    to 0. The port's return frequency lies within 3 sigma of the JAX
    engine's at p = 0.25 and at p = 4, and the two differ as they should."""
    src, dst = [0, 1, 2], [1, 2, 0]
    gt = Graph.from_undirected_edges(src, dst, num_nodes=3)
    gj = JGraph.from_undirected_edges(src, dst, num_nodes=3)
    n = 4000

    def torch_return(p):
        tab = tw.AliasTables.build(gt, p=p, q=1.0)
        w = tw.simulate_walks(
            torch.Generator().manual_seed(1), torch.zeros(n, dtype=torch.long),
            *_tables_on(tab, gt), 3).numpy()
        third = w[w[:, 1] == 1, 2]
        return (third == 0).mean(), len(third)

    def jax_return(p):
        tab = jw.AliasTables.build(gj, p=p, q=1.0)
        w = np.asarray(jw.simulate_walks(
            jax.random.PRNGKey(1), jnp.zeros(n, dtype=jnp.int32),
            jnp.asarray(gj.nbr), jnp.asarray(gj.indptr[:-1]),
            jnp.asarray(gj.degree), jnp.asarray(tab.node_J),
            jnp.asarray(tab.node_q), jnp.asarray(tab.edge_J),
            jnp.asarray(tab.edge_q), walk_length=3))
        third = w[w[:, 1] == 1, 2]
        return (third == 0).mean(), len(third)

    freq = {}
    for p in (0.25, 4.0):
        (ft, nt), (fj, nj) = torch_return(p), jax_return(p)
        exact = (1 / p) / (1 / p + 1)  # return weight 1/p, the other 1
        sigma = np.sqrt(exact * (1 - exact) * (1 / nt + 1 / nj))
        assert abs(ft - fj) <= 3 * sigma, (p, ft, fj, sigma)
        freq[p] = ft
    assert freq[0.25] > freq[4.0] + 0.4
