"""Enclosing-subgraph extraction and DRNL labelling — the counterpart of
`linkpred_tpu/data/subgraph.py` (SEAL's data path).

The host part is numpy, re-implemented from the reference (which imports
jax) and array-equal to it on a shared `np.random.Generator`: the CN-vs-AA
hop heuristic, the vectorized dense extraction with its random truncation,
the CSR extraction (the C++ plane of `native.extract_subgraphs_csr` when the
library is built, else a numpy loop over the pairs), tag compaction and the
host assembly of the DGCNN inputs.

`drnl_tags` labels a padded stack on the caller's device: two BFS sweeps per
subgraph (from node 0 = u and node 1 = v) advance together, one batched
`torch.bmm` a step, until no sweep grows; then the closed-form tag of the
reference. Stopping reads one flag back to the host per BFS step (depths are
a handful). The reference's fixed trip count works around its runtime and
is not ported.

Every subgraph is padded to `max_neighbors` = K nodes: `[P, K, K]` uint8
adjacency, node order [u, v, rest], the target link masked
(`sub_adj[0, 1] = sub_adj[1, 0] = 0`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from linkpred_tpu_torch import native
from linkpred_tpu_torch.utils import metrics

_INF = np.int32(np.iinfo(np.int32).max // 4)


# ---------------------------------------------------------------------------
# hop selection heuristic
# ---------------------------------------------------------------------------


def auto_hop(adj: np.ndarray, test_pos: np.ndarray,
             test_neg: np.ndarray) -> int:
    """Hop 1 when Common-Neighbors beats Adamic-Adar in test AUC, else 2.
    AA sums 1/log(deg) of the common neighbor (the heuristic's intent; the
    reference divides by the endpoint's degree, a bug not replicated)."""
    a = adj.astype(np.float32)
    cn = a @ a
    with np.errstate(divide="ignore", invalid="ignore"):
        a_log = a / np.log(a.sum(axis=1))[:, None]
    a_log[~np.isfinite(a_log)] = 0.0
    aa = a @ a_log

    def _auc(scores):
        s = np.concatenate([scores[test_pos[:, 0], test_pos[:, 1]],
                            scores[test_neg[:, 0], test_neg[:, 1]]])
        y = np.concatenate([np.ones(len(test_pos)), np.zeros(len(test_neg))])
        return metrics.roc_auc_score(y, s)

    return 1 if _auc(cn) > _auc(aa) else 2


def auto_hop_csr(indptr: np.ndarray, indices: np.ndarray,
                 test_pos: np.ndarray, test_neg: np.ndarray) -> int:
    """`auto_hop` over CSR, for graphs too large for a dense adjacency: CN
    and AA are evaluated only at the test pairs, by sorted-row
    intersections (the dense scores at those entries)."""
    deg = np.diff(indptr).astype(np.float64)
    with np.errstate(divide="ignore"):
        inv_log = 1.0 / np.log(deg)
    inv_log[~np.isfinite(inv_log)] = 0.0

    def _scores(pairs):
        cn = np.empty(len(pairs), dtype=np.float64)
        aa = np.empty(len(pairs), dtype=np.float64)
        for i, (u, v) in enumerate(pairs):
            common = np.intersect1d(indices[indptr[u]: indptr[u + 1]],
                                    indices[indptr[v]: indptr[v + 1]],
                                    assume_unique=False)
            cn[i] = len(common)
            aa[i] = inv_log[common].sum()
        return cn, aa

    cn_p, aa_p = _scores(np.asarray(test_pos))
    cn_n, aa_n = _scores(np.asarray(test_neg))
    y = np.concatenate([np.ones(len(test_pos)), np.zeros(len(test_neg))])
    auc_cn = metrics.roc_auc_score(y, np.concatenate([cn_p, cn_n]))
    auc_aa = metrics.roc_auc_score(y, np.concatenate([aa_p, aa_n]))
    return 1 if auc_cn > auc_aa else 2


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubgraphBatch:
    """Padded stack of enclosing subgraphs (host numpy).

    nodes: [P, K] int32 original node ids (column 0 = u, 1 = v), pad 0.
    node_mask: [P, K] bool, True where a real node.
    adj: [P, K, K] uint8 subgraph adjacency with the target link masked.
    sizes: [P] int32 real node counts.
    tags: [P, K] int32 compacted DRNL tags (pad entries get tag 0's id).
    tags_size: number of distinct tags after compaction.
    """

    nodes: np.ndarray
    node_mask: np.ndarray
    adj: np.ndarray
    sizes: np.ndarray
    tags: np.ndarray
    tags_size: int


def _random_truncate(cand: np.ndarray, budget: np.ndarray, rng) -> np.ndarray:
    """Keep at most `budget[p]` True entries per row of `cand`, chosen
    uniformly at random by a random priority per entry."""
    P, N = cand.shape
    prio = rng.random((P, N), dtype=np.float32)
    prio[~cand] = -1.0
    order = np.argsort(-prio, axis=1)  # candidates first, random order
    rank = np.empty_like(order)
    np.put_along_axis(rank, order,
                      np.broadcast_to(np.arange(N), (P, N)).copy(), axis=1)
    return cand & (rank < budget[:, None])


def extract_subgraphs(pairs: np.ndarray, adj_bool: np.ndarray, hop: int,
                      max_neighbors: int = 100,
                      rng: np.random.Generator | None = None
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """k-hop enclosing subgraphs of all pairs at once over a dense [N, N]
    adjacency: start from {u, v}, add each hop's frontier neighbors, cut
    uniformly at random at the `max_neighbors` cap, order the nodes [u, v,
    rest], take the induced adjacency and mask the target link. Returns
    (nodes [P, K], node_mask [P, K], adj [P, K, K] uint8, sizes [P])."""
    rng = rng or np.random.default_rng(0)
    pairs = np.asarray(pairs, dtype=np.int64)
    P = pairs.shape[0]
    N = adj_bool.shape[0]
    K = max_neighbors

    u, v = pairs[:, 0], pairs[:, 1]
    selected = np.zeros((P, N), dtype=bool)
    selected[np.arange(P), u] = True
    selected[np.arange(P), v] = True

    for _ in range(int(hop)):
        frontier = (selected.astype(np.float32)
                    @ adj_bool.astype(np.float32)) > 0
        cand = frontier & ~selected
        budget = K - selected.sum(axis=1)
        selected |= _random_truncate(cand, budget, rng)

    sizes = selected.sum(axis=1).astype(np.int32)

    # node order [u, v, other selected nodes]; 0 beyond `sizes`
    rest = selected.copy()
    rest[np.arange(P), u] = False
    rest[np.arange(P), v] = False
    nodes = np.zeros((P, K), dtype=np.int32)
    node_mask = np.zeros((P, K), dtype=bool)
    nodes[:, 0], nodes[:, 1] = u, v
    node_mask[:, 0] = True
    node_mask[:, 1] = True
    r, c = np.nonzero(rest)
    row_start = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(rest.sum(axis=1), out=row_start[1:])
    pos = np.arange(len(r)) - row_start[r] + 2
    nodes[r, pos] = c
    node_mask[r, pos] = True

    sub_adj = adj_bool[nodes[:, :, None], nodes[:, None, :]].astype(np.uint8)
    sub_adj &= (node_mask[:, :, None] & node_mask[:, None, :]).astype(np.uint8)
    sub_adj[:, 0, 1] = 0
    sub_adj[:, 1, 0] = 0
    return nodes, node_mask, sub_adj, sizes


def extract_subgraphs_csr(pairs: np.ndarray, indptr: np.ndarray,
                          indices: np.ndarray, num_nodes: int, hop: int,
                          max_neighbors: int = 100, seed: int = 0
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """`extract_subgraphs` over CSR (`indptr`/`indices`), for graphs where a
    dense adjacency cannot exist: O(P·K²) memory. Runs the threaded C++ plane
    (`native.extract_subgraphs_csr`, its own random stream from `seed`) when
    the library is built, else a numpy loop over the pairs that draws from
    `np.random.default_rng(seed)`. A pair with u == v starts from {u}."""
    pairs = np.ascontiguousarray(pairs, dtype=np.int32)
    if native.available():
        return native.extract_subgraphs_csr(
            indptr, indices, num_nodes, pairs, int(hop), max_neighbors, seed)

    rng = np.random.default_rng(seed)
    P, K = pairs.shape[0], max_neighbors
    nodes = np.zeros((P, K), dtype=np.int32)
    node_mask = np.zeros((P, K), dtype=bool)
    adj = np.zeros((P, K, K), dtype=np.uint8)
    sizes = np.zeros(P, dtype=np.int32)
    for p in range(P):
        u, v = int(pairs[p, 0]), int(pairs[p, 1])
        sel = [u] if u == v else [u, v]
        for _ in range(int(hop)):
            budget = K - len(sel)
            if budget <= 0:
                break
            cand = np.unique(np.concatenate(
                [indices[indptr[w]: indptr[w + 1]] for w in sel]))
            cand = cand[~np.isin(cand, np.asarray(sel, dtype=np.int64))]
            if len(cand) == 0:
                break
            if len(cand) > budget:
                cand = rng.choice(cand, size=budget, replace=False)
            sel.extend(int(c) for c in cand)
        sz = len(sel)
        sizes[p] = sz
        sel_arr = np.asarray(sel, dtype=np.int32)
        nodes[p, :sz] = sel_arr
        node_mask[p, :sz] = True
        local = {int(w): i for i, w in enumerate(sel_arr)}
        for i, w in enumerate(sel_arr):
            for x in indices[indptr[w]: indptr[w + 1]]:
                j = local.get(int(x))
                if j is not None:
                    adj[p, i, j] = 1
        if sz >= 2:
            adj[p, 0, 1] = 0
            adj[p, 1, 0] = 0
    return nodes, node_mask, adj, sizes


# ---------------------------------------------------------------------------
# DRNL labelling
# ---------------------------------------------------------------------------


def drnl_tags(adj: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Double-Radius Node Labeling of a padded stack on its device.

    `adj` [P, K, K] (uint8 or bool, target link masked) and `node_mask`
    [P, K] bool tensors -> tags [P, K] int32: with BFS distances dx, dy from
    node 0 and node 1 and d = dx + dy, `1 + min(dx, dy) + (d//2) *
    (d//2 + d%2 - 1)`; 0 where unreachable from either endpoint, 1 at the
    endpoints, 0 on padding."""
    mask = node_mask.bool()
    a = (adj > 0) & mask[:, :, None] & mask[:, None, :]
    P, K = mask.shape
    af = a.float()  # 0/1 entries and counts <= K: exact in f32
    # reach[p, s, k]: node k of subgraph p reached from source s (0 = u, 1 = v)
    reach = torch.zeros((P, 2, K), dtype=torch.bool, device=a.device)
    reach[:, 0, 0] = True
    reach[:, 1, 1] = True
    inf = int(_INF)
    dist = torch.where(reach, 0, inf).to(torch.int32)
    step = 0
    while True:
        grown = torch.bmm(reach.float(), af) > 0
        new = grown & ~reach
        if not bool(new.any()):  # one host read per BFS step
            break
        step += 1
        dist = torch.where(new, step, dist)
        reach |= new

    dx, dy = dist[:, 0], dist[:, 1]
    reachable = (dx < inf) & (dy < inf)
    d = torch.where(reachable, dx + dy, 0)  # no int32 overflow on INF
    div, mod = d // 2, d % 2
    tag = 1 + torch.minimum(dx, dy) + div * (div + mod - 1)
    tag = torch.where(reachable, tag, 0)
    tag[:, :2] = 1  # endpoints
    return torch.where(mask, tag, 0).to(torch.int32)


def compact_tags(tags: np.ndarray,
                 node_mask: np.ndarray) -> tuple[np.ndarray, int]:
    """Map the observed tag vocabulary (0 always in it) to contiguous ids
    0..T-1, in order; returns (ids [P, K], T)."""
    vocab = np.unique(tags[node_mask])
    if 0 not in vocab:
        vocab = np.concatenate([[0], vocab])
    lut = np.zeros(int(vocab.max()) + 1, dtype=np.int32)
    lut[vocab] = np.arange(len(vocab), dtype=np.int32)
    return lut[tags], int(len(vocab))


def _drnl_host(adj: np.ndarray, node_mask: np.ndarray, device) -> np.ndarray:
    return drnl_tags(torch.as_tensor(adj, device=device),
                     torch.as_tensor(node_mask, device=device)).cpu().numpy()


def build_subgraph_batch(pairs: np.ndarray, adj_bool: np.ndarray, hop: int,
                         max_neighbors: int = 100,
                         rng: np.random.Generator | None = None, *,
                         device) -> SubgraphBatch:
    """Dense extraction on the host, DRNL on `device`, tags compacted."""
    nodes, node_mask, adj, sizes = extract_subgraphs(
        pairs, adj_bool, hop, max_neighbors, rng)
    tags, tags_size = compact_tags(_drnl_host(adj, node_mask, device),
                                   node_mask)
    return SubgraphBatch(nodes=nodes, node_mask=node_mask, adj=adj,
                         sizes=sizes, tags=tags, tags_size=tags_size)


def build_subgraph_batch_csr(pairs: np.ndarray, indptr: np.ndarray,
                             indices: np.ndarray, num_nodes: int, hop: int,
                             max_neighbors: int = 100, seed: int = 0,
                             drnl_chunk: int = 4096, *,
                             device) -> SubgraphBatch:
    """CSR extraction and DRNL in the threaded C++ plane
    (`native.drnl_tags_batch`; a 100-node BFS is host-sized integer work)
    when the library is built, else `drnl_tags` on `device` in chunks of
    `drnl_chunk` pairs."""
    nodes, node_mask, adj, sizes = extract_subgraphs_csr(
        pairs, indptr, indices, num_nodes, hop, max_neighbors, seed)
    if native.available():
        tags = native.drnl_tags_batch(adj, node_mask, sizes)
    else:
        tags = np.concatenate([
            _drnl_host(adj[s: s + drnl_chunk], node_mask[s: s + drnl_chunk],
                       device)
            for s in range(0, len(nodes), drnl_chunk)], axis=0)
    tags, tags_size = compact_tags(tags, node_mask)
    return SubgraphBatch(nodes=nodes, node_mask=node_mask, adj=adj,
                         sizes=sizes, tags=tags, tags_size=tags_size)


# ---------------------------------------------------------------------------
# GNN input assembly on the host
# ---------------------------------------------------------------------------


def gnn_inputs(batch: SubgraphBatch, embedding: np.ndarray | None
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(d_inv [P, K], a_tilde [P, K, K], x [P, K, F]) for the DGCNN: A~ = A
    + I, the inverse row sums of A~ (D is diagonal, so D^-1 is a row
    scale), X = one-hot tag ++ embedding rows. Padded nodes get self-loop
    rows and zero features, so their activations stay exactly zero."""
    P, K = batch.tags.shape
    eye = np.eye(K, dtype=np.float32)
    a_tilde = batch.adj.astype(np.float32) + eye[None]
    d_inv = 1.0 / a_tilde.sum(axis=2)

    x = np.eye(batch.tags_size, dtype=np.float32)[batch.tags]  # [P, K, T]
    x *= batch.node_mask[:, :, None]
    if embedding is not None:
        emb = embedding[batch.nodes].astype(np.float32)
        emb *= batch.node_mask[:, :, None]
        x = np.concatenate([x, emb], axis=2)
    return d_inv.astype(np.float32), a_tilde, x
