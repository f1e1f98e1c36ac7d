"""Core graph substrate: static-shape sparse adjacency, built on the host.

The port's own copy of `linkpred_tpu/data/graph.py` (numpy only, same names
and behaviour; the port imports nothing of the JAX package).

The reference framework keeps graphs as networkx objects and torch COO tensors
(e.g. `LogisticRegression_Linkprediction/data/understanding_data.py:31-33`,
`TwoWL/operators/datasets.py:154-168` in the reference repo). The device code
wants static shapes, so a `Graph` carries three coordinated views, all built
once on the host (numpy) and shipped to the device:

- **COO** `src`/`dst` int32 arrays (edge list, possibly symmetrized),
- **CSR** `indptr`/`indices` (sorted by row; contiguous segments per node),
- **ELL** `nbr`/`nbr_mask` — a `[num_nodes, max_degree]` padded neighbor
  matrix. Gathers over ELL rows are static-shaped and vectorize cleanly,
  which makes it the preferred layout for the SpMM aggregation kernels
  (`linkpred_tpu_torch.ops.spmm`).

Construction is host-side and cheap (one pass of `np.argsort`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """An immutable sparse graph with COO + CSR + ELL views (host numpy).

    `src`/`dst` hold each *directed* edge once. For an undirected graph built
    with `from_undirected_edges`, both orientations are present, so
    `num_edges == 2 * num_undirected_edges`.
    """

    num_nodes: int
    src: np.ndarray  # [E] int32
    dst: np.ndarray  # [E] int32
    indptr: np.ndarray  # [N+1] int32, CSR row pointers (rows = src)
    indices: np.ndarray  # [E] int32, CSR column indices sorted by row
    nbr: np.ndarray  # [N, max_degree] int32 padded neighbors (pad = 0)
    nbr_mask: np.ndarray  # [N, max_degree] bool, True where a real neighbor
    degree: np.ndarray  # [N] int32 out-degree
    nbr_weight: np.ndarray | None = None  # [N, max_degree] float32 (None = 1s)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def max_degree(self) -> int:
        return int(self.nbr.shape[1])

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @staticmethod
    def from_edges(
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: Optional[int] = None,
        max_degree: Optional[int] = None,
        weight: Optional[np.ndarray] = None,
    ) -> "Graph":
        """Build from a directed edge list (each edge used exactly as given).

        `weight` (optional [E] floats) flows into the padded `nbr_weight`
        matrix; the walk engine uses it for weighted transition
        probabilities (reference `node2vec/src/main.py:41-47` --weighted).
        """
        src = np.asarray(src, dtype=np.int32).reshape(-1)
        dst = np.asarray(dst, dtype=np.int32).reshape(-1)
        if num_nodes is None:
            num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1

        # CSR: sort edges by (src, dst) for contiguous row segments.
        order = np.lexsort((dst, src))
        s_sorted, d_sorted = src[order], dst[order]
        degree = np.bincount(s_sorted, minlength=num_nodes).astype(np.int32)
        indptr = np.zeros(num_nodes + 1, dtype=np.int32)
        np.cumsum(degree, out=indptr[1:])

        max_deg = int(degree.max(initial=0))
        if max_degree is not None:
            max_deg = max(max_deg, int(max_degree))
        max_deg = max(max_deg, 1)

        # ELL: scatter sorted neighbors into a padded [N, max_deg] matrix.
        nbr = np.zeros((num_nodes, max_deg), dtype=np.int32)
        mask = np.zeros((num_nodes, max_deg), dtype=bool)
        # position of each edge within its row
        row_pos = np.arange(len(s_sorted), dtype=np.int64) - indptr[s_sorted]
        nbr[s_sorted, row_pos] = d_sorted
        mask[s_sorted, row_pos] = True

        nbr_w = None
        if weight is not None:
            w_sorted = np.asarray(weight, dtype=np.float32).reshape(-1)[order]
            nbr_w = np.zeros((num_nodes, max_deg), dtype=np.float32)
            nbr_w[s_sorted, row_pos] = w_sorted

        return Graph(
            num_nodes=num_nodes,
            src=s_sorted,
            dst=d_sorted,
            indptr=indptr,
            indices=d_sorted,
            nbr=nbr,
            nbr_mask=mask,
            degree=degree,
            nbr_weight=nbr_w,
        )

    @staticmethod
    def from_undirected_edges(
        u: np.ndarray,
        v: np.ndarray,
        num_nodes: Optional[int] = None,
        max_degree: Optional[int] = None,
        weight: Optional[np.ndarray] = None,
    ) -> "Graph":
        """Build from undirected pairs; stores both orientations, drops
        duplicate pairs and self-loops (the fb-pages-food edge file has
        neither, but synthetic generators may). `weight` ([#pairs] floats)
        applies to both orientations of each kept pair."""
        u = np.asarray(u, dtype=np.int64).reshape(-1)
        v = np.asarray(v, dtype=np.int64).reshape(-1)
        keep = u != v
        u, v = u[keep], v[keep]
        if weight is not None:
            weight = np.asarray(weight).reshape(-1)[keep]
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        if num_nodes is None:
            num_nodes = int(max(lo.max(initial=-1), hi.max(initial=-1))) + 1
        key = lo * num_nodes + hi
        _, uniq = np.unique(key, return_index=True)
        lo, hi = lo[uniq], hi[uniq]
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        w2 = None
        if weight is not None:
            weight = weight[uniq]
            w2 = np.concatenate([weight, weight])
        return Graph.from_edges(src, dst, num_nodes=num_nodes,
                                max_degree=max_degree, weight=w2)

    def with_degree_cap(self, cap: int, rng=None,
                        symmetric: bool = False) -> "Graph":
        """Keep at most `cap` out-edges per node (random subset) — the walk
        engine's analog of the Spark loader's degree cap
        (reference `Node2vec.scala:47-49`, cap 30). Bounds ELL width and
        alias-table size on power-law graphs.

        `symmetric=True` caps by dropping *undirected pairs* (both
        orientations of an edge go together), so the capped adjacency of an
        undirected graph stays symmetric. Required whenever the result
        feeds a kernel whose backward assumes `A == A^T`
        (`parallel.spmm_shard.spmm_node_sharded_sym`): the per-orientation
        cap drops out-edges independently and produces an asymmetric
        pattern on any graph with hubs, silently corrupting that VJP."""
        rng = rng or np.random.default_rng(0)
        if not symmetric:
            keep = np.ones(self.num_edges, dtype=bool)
            for v in np.nonzero(self.degree > cap)[0]:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                drop = rng.permutation(hi - lo)[: (hi - lo) - cap]
                keep[lo + drop] = False
            return Graph.from_edges(
                self.src[keep], self.dst[keep], num_nodes=self.num_nodes
            )

        # Symmetric: one pass over over-cap nodes dropping whole pairs.
        # Processing node v leaves deg(v) <= cap; later drops only ever
        # REDUCE degrees, so a single pass caps every node.
        pairs = self.undirected_pairs()  # [M, 2], lo < hi
        m = len(pairs)
        # incident pair ids per node, CSR-style over the doubled endpoints
        ends = np.concatenate([pairs[:, 0], pairs[:, 1]])
        pid = np.tile(np.arange(m, dtype=np.int64), 2)
        order = np.argsort(ends, kind="stable")
        ends_s, pid_s = ends[order], pid[order]
        deg = np.bincount(ends_s, minlength=self.num_nodes)
        ptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(deg, out=ptr[1:])
        kept = np.ones(m, dtype=bool)
        cur = deg.copy()
        for v in np.nonzero(deg > cap)[0]:
            if cur[v] <= cap:
                continue
            mine = pid_s[ptr[v]:ptr[v + 1]]
            alive = mine[kept[mine]]
            drop = rng.permutation(len(alive))[: len(alive) - cap]
            dropped = alive[drop]
            kept[dropped] = False
            other = np.where(pairs[dropped, 0] == v, pairs[dropped, 1],
                             pairs[dropped, 0])
            cur[v] = cap
            np.subtract.at(cur, other, 1)
        p = pairs[kept]
        return Graph.from_undirected_edges(p[:, 0], p[:, 1],
                                           num_nodes=self.num_nodes)

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------

    def undirected_pairs(self) -> np.ndarray:
        """Return the [M, 2] unique (lo < hi) pairs of this graph."""
        m = self.src < self.dst
        return np.stack([self.src[m], self.dst[m]], axis=1)

    def dense_adjacency(self, dtype=np.float32) -> np.ndarray:
        a = np.zeros((self.num_nodes, self.num_nodes), dtype=dtype)
        a[self.src, self.dst] = 1
        return a

    def has_edge_matrix(self) -> np.ndarray:
        """Boolean [N, N] adjacency (host-side, for small graphs/tests)."""
        return self.dense_adjacency(dtype=bool)

    def subgraph_adjacency(self, nodes: np.ndarray) -> np.ndarray:
        """Dense adjacency restricted to `nodes` (in their given order)."""
        a = self.dense_adjacency(dtype=np.uint8)
        return a[np.ix_(nodes, nodes)]
