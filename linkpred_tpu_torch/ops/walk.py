"""2nd-order (node2vec) biased random walks — the counterpart of
`linkpred_tpu/ops/walk.py`.

Host side (numpy, with the C++ routines of `linkpred_tpu_torch.native` when
they are at hand): `alias_setup_rows` and `AliasTables.build`, array-equal to
the JAX package's. Alias tables are built once over the padded ELL neighbor
matrix, per node (first hop) and per directed edge (later hops, biased by
p and q).

Device side (torch): `simulate_walks` advances all walkers together, one
step of a few batched gathers per hop; the walker state carries the directed
edge id of the last hop, so the 2nd-order table lookup is a row gather. The
loop reads nothing back to the host, and the walk matrix stays on the
device. The random streams are torch's, so walks agree with the JAX
package's in distribution, not draw for draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from linkpred_tpu_torch.data.graph import Graph


def alias_setup_rows(probs: np.ndarray, valid: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Alias construction row by row (Vose), in numpy.

    `probs` [R, D] rows of (unnormalized) probabilities, `valid` [R, D] bool.
    Returns (J [R, D] int32, q [R, D] float32) such that drawing slot
    `k ~ U{0..deg-1}` and accepting `k` with probability `q[k]` (else taking
    `J[k]`) samples slot k with probability probs[k] / sum(probs).
    """
    R, D = probs.shape
    J = np.zeros((R, D), dtype=np.int32)
    q = np.zeros((R, D), dtype=np.float32)
    deg = valid.sum(axis=1)
    for r in range(R):
        K = int(deg[r])
        if K == 0:
            continue
        p = probs[r, :K].astype(np.float64)
        s = p.sum()
        if s <= 0:
            p = np.ones(K) / K
        else:
            p = p / s
        qr = K * p
        Jr = np.zeros(K, dtype=np.int64)
        smaller = [k for k in range(K) if qr[k] < 1.0]
        larger = [k for k in range(K) if qr[k] >= 1.0]
        while smaller and larger:
            small, large = smaller.pop(), larger.pop()
            Jr[small] = large
            qr[large] = qr[large] + qr[small] - 1.0
            if qr[large] < 1.0:
                smaller.append(large)
            else:
                larger.append(large)
        J[r, :K] = Jr
        q[r, :K] = qr
    return J, q


@dataclasses.dataclass(frozen=True)
class AliasTables:
    """Per-node (first hop) and per-directed-edge (2nd-order) alias tables.

    node_J/node_q: [N, D] over each node's neighbor slots.
    edge_J/edge_q: [E, D]; row e is the table over the slots of `nbr[dst of
    e]`, biased by p (return) and q (in-out) as node2vec's `get_alias_edge`.
    """

    node_J: np.ndarray
    node_q: np.ndarray
    edge_J: np.ndarray
    edge_q: np.ndarray

    @staticmethod
    def build(g: Graph, p: float = 1.0, q: float = 1.0) -> "AliasTables":
        from linkpred_tpu_torch import native

        w = (
            g.nbr_weight.astype(np.float64)
            if g.nbr_weight is not None
            else g.nbr_mask.astype(np.float64)  # unweighted: weight 1 an edge
        )
        node_J, node_q = native.build_alias_rows(w, g.nbr_mask)

        if p == 1.0 and q == 1.0 and g.nbr_weight is None:
            # 1st-order unweighted walk: every edge table equals the table
            # of the edge's destination node
            return AliasTables(node_J, node_q, node_J[g.dst], node_q[g.dst])

        valid = g.nbr_mask[g.dst]
        if native.available():
            # C++: membership by binary search over the CSR rows; edge
            # weights, when present, scale the bias in the same pass
            probs = native.edge_bias_probs(
                g.src, g.dst, g.nbr, g.nbr_mask, g.indptr, g.indices, p, q,
                nbr_weight=g.nbr_weight,
            )
        else:
            # numpy: dense has-edge lookup (fine up to ~20k nodes)
            has_edge = g.has_edge_matrix()
            nbrs = g.nbr[g.dst]  # [E, D]
            pe = np.where(
                nbrs == g.src[:, None],
                1.0 / p,
                np.where(has_edge[nbrs, g.src[:, None]], 1.0, 1.0 / q),
            )
            probs = np.where(valid, pe, 0.0)
            if g.nbr_weight is not None:
                probs = probs * g.nbr_weight[g.dst]
        edge_J, edge_q = native.build_alias_rows(probs, valid)
        return AliasTables(node_J, node_q, edge_J, edge_q)


def alias_draw_batch(generator: torch.Generator, J: torch.Tensor,
                     q: torch.Tensor, rows: torch.Tensor,
                     deg: torch.Tensor) -> torch.Tensor:
    """One alias draw per walker: `J`/`q` [R, D] tables, `rows` [W] int64
    the table row of each walker, `deg` [W] int64 its live slot count ->
    slots [W] int64 (0 where `deg` is 0). Two uniforms per walker, drawn on
    the tables' device from `generator`."""
    u = torch.rand((2, rows.shape[0]), generator=generator, device=J.device)
    kk = torch.minimum((u[0] * deg).long(), (deg - 1).clamp(min=0))
    return torch.where(u[1] < q[rows, kk], kk, J[rows, kk].long())


@torch.no_grad()
def simulate_walks(generator: torch.Generator, starts: torch.Tensor,
                   nbr: torch.Tensor, indptr: torch.Tensor,
                   degree: torch.Tensor, node_J: torch.Tensor,
                   node_q: torch.Tensor, edge_J: torch.Tensor,
                   edge_q: torch.Tensor, walk_length: int) -> torch.Tensor:
    """Batched biased walks: int32 [num_starts, walk_length] on the device
    of the tables.

    A step loop with all walkers advancing together: the first hop draws
    from the node tables, later hops from the edge tables by the directed
    edge id of the last hop (`indptr[node] + slot`; `indptr` is the CSR row
    pointer without its last entry). A walker at a degree-0 node stays in
    place for the rest of the walk; the pair sampler masks its self pairs.
    Nothing in the loop is read back to the host."""
    starts = starts.long()
    degree, indptr = degree.long(), indptr.long()

    deg0 = degree[starts]
    slot0 = alias_draw_batch(generator, node_J, node_q, starts, deg0)
    stalled = deg0 == 0
    cur = torch.where(stalled, starts, nbr[starts, slot0].long())
    eid = torch.where(stalled, 0, indptr[starts] + slot0)

    walk = torch.empty((starts.shape[0], walk_length), dtype=torch.int32,
                       device=starts.device)
    walk[:, 0] = starts
    walk[:, 1] = cur
    for t in range(2, walk_length):
        deg = degree[cur]
        slot = alias_draw_batch(generator, edge_J, edge_q, eid, deg)
        stalled = stalled | (deg == 0)
        eid = torch.where(stalled, eid, indptr[cur] + slot)
        cur = torch.where(stalled, cur, nbr[cur, slot].long())
        walk[:, t] = cur
    return walk


class WalkEngine:
    """Build the tables from a `Graph`, hold them on `device`, run walks
    there. Each of the `num_walks` rounds starts one walk from every node
    (all walks run at once, so their order does not matter)."""

    def __init__(self, g: Graph, p: float = 1.0, q: float = 1.0, *, device):
        self.graph = g
        self.device = torch.device(device)
        tables = AliasTables.build(g, p=p, q=q)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        self.nbr = put(g.nbr)
        self.indptr = put(g.indptr[:-1])
        self.degree = put(g.degree)
        self.node_J, self.node_q = put(tables.node_J), put(tables.node_q)
        self.edge_J, self.edge_q = put(tables.edge_J), put(tables.edge_q)

    def walks(self, generator: torch.Generator, num_walks: int,
              walk_length: int) -> torch.Tensor:
        """[num_walks * N, walk_length] int32 walk matrix on the device;
        `generator` is a `torch.Generator` of that device."""
        n = self.graph.num_nodes
        starts = torch.arange(n, device=self.device).repeat(num_walks)
        return simulate_walks(
            generator, starts, self.nbr, self.indptr, self.degree,
            self.node_J, self.node_q, self.edge_J, self.edge_q, walk_length)
