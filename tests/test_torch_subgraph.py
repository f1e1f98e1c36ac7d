"""SEAL's subgraph data in the port (`linkpred_tpu_torch.data.subgraph`)
against the JAX package's `linkpred_tpu.data.subgraph`, on the same numpy
inputs: host arrays array-equal; the port's `drnl_tags` equal to the JAX
`drnl_tags`, to the C++ `drnl_tags_batch` and to a shortest-path oracle.
Mirrors `tests/test_subgraph.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linkpred_tpu import native as jnative
from linkpred_tpu.data import subgraph as jsg
from linkpred_tpu.data.graph import Graph as JGraph
from linkpred_tpu_torch import native as tnative
from linkpred_tpu_torch.data import subgraph as sg
from linkpred_tpu_torch.data.graph import Graph

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(a)


def port_drnl(adj, mask):
    return sg.drnl_tags(_t(adj), _t(mask)).numpy()


def jax_drnl(adj, mask):
    return np.asarray(jsg.drnl_tags(jnp.asarray(adj), jnp.asarray(mask),
                                    adj.shape[1]))


# ---------------------------------------------------------------------------
# the oracle and fixtures of tests/test_subgraph.py
# ---------------------------------------------------------------------------


def bfs_dists(adj: np.ndarray, source: int) -> np.ndarray:
    n = adj.shape[0]
    dist = np.full(n, np.iinfo(np.int32).max // 4, dtype=np.int64)
    dist[source] = 0
    frontier, d = [source], 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in np.nonzero(adj[u])[0]:
                if dist[v] > d:
                    dist[v] = d
                    nxt.append(v)
        frontier = nxt
    return dist


def oracle_drnl(adj: np.ndarray, n: int) -> np.ndarray:
    dx = bfs_dists(adj[:n, :n], 0)
    dy = bfs_dists(adj[:n, :n], 1)
    INF = np.iinfo(np.int32).max // 4
    tags = np.zeros(n, dtype=np.int64)
    for i in range(2, n):
        if dx[i] < INF and dy[i] < INF:
            d = dx[i] + dy[i]
            div, mod = divmod(d, 2)
            tags[i] = 1 + min(dx[i], dy[i]) + div * (div + mod - 1)
    tags[0] = tags[1] = 1
    return tags


def random_subgraph_batch(rng, P=16, K=24, p_edge=0.12):
    adj = np.zeros((P, K, K), dtype=np.uint8)
    mask = np.zeros((P, K), dtype=bool)
    sizes = rng.integers(2, K + 1, size=P)
    for i in range(P):
        n = int(sizes[i])
        a = (rng.random((n, n)) < p_edge).astype(np.uint8)
        a = np.triu(a, 1)
        a = a + a.T
        a[0, 1] = a[1, 0] = 0  # target link masked
        adj[i, :n, :n] = a
        mask[i, :n] = True
    return adj, mask, sizes


class TestDRNL:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_oracle_jax_and_native(self, seed):
        adj, mask, sizes = random_subgraph_batch(np.random.default_rng(seed))
        tags = port_drnl(adj, mask)
        assert tags.dtype == np.int32
        np.testing.assert_array_equal(tags, jax_drnl(adj, mask))
        np.testing.assert_array_equal(
            tags, tnative.drnl_tags_batch(adj, mask, sizes))
        for i in range(adj.shape[0]):
            n = int(sizes[i])
            np.testing.assert_array_equal(tags[i, :n], oracle_drnl(adj[i], n))
            assert (tags[i, n:] == 0).all()

    def test_path_graph_tags(self):
        # 0 - 2 - 1 chain: node 2 has dx = dy = 1, d = 2 -> tag 2
        adj = np.zeros((1, 4, 4), dtype=np.uint8)
        adj[0, 0, 2] = adj[0, 2, 0] = 1
        adj[0, 1, 2] = adj[0, 2, 1] = 1
        mask = np.array([[True, True, True, False]])
        np.testing.assert_array_equal(port_drnl(adj, mask)[0], [1, 1, 2, 0])

    def test_unreachable_gets_zero(self):
        adj = np.zeros((1, 3, 3), dtype=np.uint8)
        mask = np.array([[True, True, True]])
        np.testing.assert_array_equal(port_drnl(adj, mask)[0], [1, 1, 0])

    def test_long_paths_and_bool_adjacency(self):
        """A path of 40 nodes through both endpoints (BFS depth 38), one
        side reachable from u only; bool input as well as uint8."""
        K = 48
        adj = np.zeros((2, K, K), dtype=bool)
        order = [0] + list(range(2, 40)) + [1]
        for a, b in zip(order[:-1], order[1:]):
            adj[0, a, b] = adj[0, b, a] = True
        for a, b in zip([0] + list(range(40, 46)), range(40, 47)):
            adj[1, a, b] = adj[1, b, a] = True  # a tail off u only
        mask = np.zeros((2, K), dtype=bool)
        mask[0, :40] = True
        mask[1, :47] = True
        tags = port_drnl(adj, mask)
        np.testing.assert_array_equal(tags, jax_drnl(adj, mask))
        np.testing.assert_array_equal(tags[0, :40], oracle_drnl(adj[0], 40))
        np.testing.assert_array_equal(tags[1, 2:47], 0)

    def test_pair_with_equal_endpoints_tags_like_native(self):
        """The CSR extraction's u == v case: one real node; the port tags
        it as the C++ plane does."""
        n, K = 30, 12
        rng = np.random.default_rng(5)
        e = rng.integers(0, n, (80, 2))
        e = e[e[:, 0] != e[:, 1]]
        g = Graph.from_undirected_edges(e[:, 0], e[:, 1], num_nodes=n)
        pairs = np.array([[3, 3], [4, 7], [9, 9]])
        nodes, mask, adj, sizes = tnative.extract_subgraphs_csr(
            g.indptr, g.indices, n, pairs, 1, K, seed=2)
        assert sizes[0] == 1 + len(set(g.indices[g.indptr[3]:g.indptr[4]]))
        np.testing.assert_array_equal(
            port_drnl(adj, mask), tnative.drnl_tags_batch(adj, mask, sizes))


class TestExtraction:
    def _toy_adj(self):
        n = 6  # 6-cycle + one chord
        adj = np.zeros((n, n), dtype=bool)
        for i in range(n):
            adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
        adj[0, 3] = adj[3, 0] = True
        return adj

    @pytest.mark.parametrize("hop,K", [(1, 6), (2, 10), (2, 4)])
    def test_equal_to_jax_on_shared_rng(self, hop, K):
        adj = self._toy_adj()
        pairs = np.array([[0, 1], [2, 5], [4, 3]])
        got = sg.extract_subgraphs(pairs, adj, hop, K,
                                   np.random.default_rng(9))
        ref = jsg.extract_subgraphs(pairs, adj, hop, K,
                                    np.random.default_rng(9))
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    def test_truncation_equal_to_jax(self):
        """The random cap on a dense graph: same draws, same subgraphs."""
        adj = np.ones((50, 50), dtype=bool)
        np.fill_diagonal(adj, False)
        pairs = np.array([[0, 1], [5, 9], [7, 2]])
        got = sg.extract_subgraphs(pairs, adj, 2, 10,
                                   np.random.default_rng(3))
        ref = jsg.extract_subgraphs(pairs, adj, 2, 10,
                                    np.random.default_rng(3))
        assert (got[3] == 10).all()
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)

    def test_target_link_masked(self):
        adj = self._toy_adj()
        nodes, mask, sub, _ = sg.extract_subgraphs(
            np.array([[0, 1]]), adj, hop=1, max_neighbors=6,
            rng=np.random.default_rng(0))
        assert sub[0, 0, 1] == 0 and sub[0, 1, 0] == 0
        order = nodes[0, mask[0]]
        ref = adj[np.ix_(order, order)].astype(np.uint8)
        ref[0, 1] = ref[1, 0] = 0
        np.testing.assert_array_equal(sub[0][: len(order), : len(order)], ref)

    def test_compact_tags_equal(self):
        tags = np.array([[1, 1, 7, 3], [1, 1, 0, 7]])
        mask = np.array([[True] * 4, [True, True, True, False]])
        got, size = sg.compact_tags(tags, mask)
        ref, rsize = jsg.compact_tags(tags, mask)
        assert size == rsize == 4
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got[0], [1, 1, 3, 2])

    def test_build_subgraph_batch_equal(self):
        adj = self._toy_adj()
        pairs = np.array([[0, 1], [2, 5], [1, 4], [3, 0]])
        got = sg.build_subgraph_batch(pairs, adj, 2, 5,
                                      np.random.default_rng(4), device="cpu")
        ref = jsg.build_subgraph_batch(pairs, adj, 2, 5,
                                       np.random.default_rng(4))
        for f in ("nodes", "node_mask", "adj", "sizes", "tags"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                          err_msg=f)
        assert got.tags_size == ref.tags_size


class TestAutoHop:
    def test_equal_to_jax(self, fb_graph):
        g, _ = fb_graph
        adj = g.has_edge_matrix()
        rng = np.random.default_rng(0)
        pos = np.stack([g.src[g.src < g.dst], g.dst[g.src < g.dst]], axis=1)
        test_pos = pos[rng.permutation(len(pos))[:100]]
        neg = np.stack(np.nonzero(np.triu(~adj, 1)), axis=1)
        test_neg = neg[rng.permutation(len(neg))[:100]]
        hop = sg.auto_hop(adj, test_pos, test_neg)
        assert hop in (1, 2)
        assert hop == jsg.auto_hop(adj, test_pos, test_neg)


class TestGnnInputs:
    def test_equal_to_jax_and_padding(self):
        rng = np.random.default_rng(7)
        adj, mask, sizes = random_subgraph_batch(rng, P=4, K=8)
        tags, tsize = sg.compact_tags(port_drnl(adj, mask), mask)
        nodes = rng.integers(0, 5, (4, 8)).astype(np.int32) * mask
        emb = rng.standard_normal((5, 16)).astype(np.float32)
        kw = dict(nodes=nodes, node_mask=mask, adj=adj,
                  sizes=sizes.astype(np.int32), tags=tags, tags_size=tsize)
        got = sg.gnn_inputs(sg.SubgraphBatch(**kw), emb)
        ref = jsg.gnn_inputs(jsg.SubgraphBatch(**kw), emb)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        d_inv, _, x = got
        assert x.shape == (4, 8, tsize + 16)
        for i in range(4):
            n = int(sizes[i])
            assert np.all(x[i, n:] == 0)
            np.testing.assert_allclose(d_inv[i, n:], 1.0)
        # no embedding: the one-hot tags alone
        x0 = sg.gnn_inputs(sg.SubgraphBatch(**kw), None)[2]
        np.testing.assert_array_equal(
            x0, jsg.gnn_inputs(jsg.SubgraphBatch(**kw), None)[2])


class TestCSRExtraction:
    def _graph(self, seed=0, n=150, e=500):
        rng = np.random.default_rng(seed)
        pairs = rng.integers(0, n, (e, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1],
                                        num_nodes=n)
        gj = JGraph.from_undirected_edges(pairs[:, 0], pairs[:, 1],
                                          num_nodes=n)
        np.testing.assert_array_equal(g.indices, gj.indices)
        adj = np.zeros((n, n), dtype=bool)
        adj[g.src, g.dst] = True
        return g, adj, rng

    @pytest.mark.parametrize("hop,K", [(1, 150), (2, 150), (2, 12)])
    @pytest.mark.parametrize("use_native", [True, False])
    def test_equal_to_jax(self, hop, K, use_native, monkeypatch):
        """The C++ plane of both packages, or both numpy loops on the same
        seed: array-equal, capped or not."""
        assert tnative.available() and jnative.available()
        if not use_native:
            monkeypatch.setattr(tnative, "available", lambda: False)
            monkeypatch.setattr(jnative, "available", lambda: False)
        g, adj, rng = self._graph(seed=3, n=150, e=900)
        pairs = rng.integers(0, 150, (40, 2))
        pairs[:3, 1] = pairs[:3, 0]  # u == v
        got = sg.extract_subgraphs_csr(pairs, g.indptr, g.indices, 150, hop,
                                       K, seed=9)
        ref = jsg.extract_subgraphs_csr(pairs, g.indptr, g.indices, 150, hop,
                                        K, seed=9)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        nodes, mask, a, sizes = got
        assert (sizes <= K).all() and (mask.sum(axis=1) == sizes).all()
        assert (nodes[:, 0] == pairs[:, 0]).all()
        for p in range(3, 8):
            sel = nodes[p][mask[p]]
            dense_sub = adj[np.ix_(sel, sel)].copy()
            dense_sub[0, 1] = dense_sub[1, 0] = False
            assert (a[p][: len(sel), : len(sel)] == dense_sub).all()

    @pytest.mark.parametrize("use_native", [True, False])
    def test_matches_dense_without_cap(self, use_native, monkeypatch):
        if not use_native:
            monkeypatch.setattr(tnative, "available", lambda: False)
        g, adj, rng = self._graph()
        pairs = rng.integers(0, 150, (40, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        nd, md, ad, sd = sg.extract_subgraphs(pairs, adj, 2, 150,
                                              np.random.default_rng(1))
        nc, mc, ac, s = sg.extract_subgraphs_csr(pairs, g.indptr, g.indices,
                                                 150, 2, 150, seed=1)
        assert (sd == s).all()
        for p in range(len(pairs)):
            assert set(nd[p][md[p]].tolist()) == set(nc[p][mc[p]].tolist())
            assert ad[p].sum() == ac[p].sum()

    def test_auto_hop_csr_equal(self):
        g, adj, rng = self._graph(seed=5)
        tp = rng.integers(0, 150, (30, 2))
        tp = tp[tp[:, 0] != tp[:, 1]]
        tn = rng.integers(0, 150, (30, 2))
        tn = tn[tn[:, 0] != tn[:, 1]]
        hop = sg.auto_hop_csr(g.indptr, g.indices, tp, tn)
        assert hop == sg.auto_hop(adj, tp, tn)
        assert hop == jsg.auto_hop_csr(g.indptr, g.indices, tp, tn)

    @pytest.mark.parametrize("use_native", [True, False])
    def test_batch_csr_equal_to_jax(self, use_native, monkeypatch):
        """Extraction and tags: the C++ plane in both, or the numpy loop and
        the device BFS (in chunks) against JAX's numpy loop and jit BFS."""
        if not use_native:
            monkeypatch.setattr(tnative, "available", lambda: False)
            monkeypatch.setattr(jnative, "available", lambda: False)
        g, _, rng = self._graph(seed=7)
        pairs = rng.integers(0, 150, (20, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        got = sg.build_subgraph_batch_csr(pairs, g.indptr, g.indices, 150, 2,
                                          20, seed=1, drnl_chunk=8,
                                          device="cpu")
        ref = jsg.build_subgraph_batch_csr(pairs, g.indptr, g.indices, 150,
                                           2, 20, seed=1, drnl_chunk=8)
        for f in ("nodes", "node_mask", "adj", "sizes", "tags"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                          err_msg=f)
        assert got.tags_size == ref.tags_size


class TestNativeDRNL:
    def test_matches_torch_bfs(self):
        rng = np.random.default_rng(11)
        P, K = 64, 40
        sizes = rng.integers(2, K + 1, P).astype(np.int32)
        mask = np.arange(K)[None, :] < sizes[:, None]
        adj = rng.random((P, K, K)) < 0.08
        adj = adj | adj.transpose(0, 2, 1)
        adj &= mask[:, :, None] & mask[:, None, :]
        adj = adj.astype(np.uint8)
        adj[:, 0, 1] = adj[:, 1, 0] = 0
        t_native = tnative.drnl_tags_batch(adj, mask, sizes)
        np.testing.assert_array_equal(
            t_native, jnative.drnl_tags_batch(adj, mask, sizes))
        np.testing.assert_array_equal(port_drnl(adj, mask), t_native)
