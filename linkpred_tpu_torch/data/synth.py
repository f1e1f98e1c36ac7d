"""Synthetic graph generators for the scale pipelines — the port's own copies
of `synth_powerlaw_graph` and `synth_community_graph` of
`benchmarks/scaling.py` (numpy only, same draws from the same seed)."""

from __future__ import annotations

import numpy as np


def synth_powerlaw_graph(n_nodes: int, n_edges: int, alpha: float = 0.9,
                         seed: int = 0):
    """Preferential-attachment-flavored random multigraph, deduplicated."""
    rng = np.random.default_rng(seed)
    # degree-propensity ~ zipf over node ranks
    w = (np.arange(1, n_nodes + 1, dtype=np.float64)) ** (-alpha)
    w /= w.sum()
    u = rng.choice(n_nodes, size=int(n_edges * 1.3), p=w)
    v = rng.integers(0, n_nodes, size=int(n_edges * 1.3))
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    key = lo.astype(np.int64) * n_nodes + hi
    _, idx = np.unique(key, return_index=True)
    idx = idx[: n_edges]
    return lo[idx], hi[idx]


def synth_community_graph(n_nodes: int, n_edges: int, n_comm: int = 64,
                          p_intra: float = 0.92, alpha: float = 0.9,
                          seed: int = 0):
    """Community-structured power-law graph (the realistic regime for
    collaboration networks like ogbl-collab: strong clustering, small
    inter-community cut). Node labels are SHUFFLED so the raw ordering
    carries no locality — a partitioner must rediscover the communities
    (what `HaloLayout`'s RCM ordering is for). Returns (lo, hi) pairs.
    """
    rng = np.random.default_rng(seed)
    # community sizes a la np.array_split: the n_nodes % n_comm remainder
    # is spread over the first communities so EVERY node is reachable (a
    # flat n_nodes // n_comm size left the trailing remainder nodes
    # permanently isolated)
    sizes = np.full(n_comm, n_nodes // n_comm, dtype=np.int64)
    sizes[: n_nodes % n_comm] += 1
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    per = int(sizes.max())
    m = int(n_edges * 1.4)
    c_u = rng.integers(0, n_comm, m)
    # within-community zipf-ish propensity
    w = (np.arange(1, per + 1, dtype=np.float64)) ** (-alpha)
    w /= w.sum()
    cross = rng.random(m) >= p_intra
    c_v = np.where(cross, rng.integers(0, n_comm, m), c_u)
    # draw over the max size, fold into the community's actual size (the
    # fold only perturbs the zipf tail of the per+1-sized communities)
    u_loc = rng.choice(per, size=m, p=w) % sizes[c_u]
    v_loc = rng.integers(0, sizes[c_v])
    u = offsets[c_u] + u_loc
    v = offsets[c_v] + v_loc
    label = rng.permutation(n_nodes)
    u, v = label[u], label[v]
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    key = lo.astype(np.int64) * n_nodes + hi
    _, idx = np.unique(key, return_index=True)
    idx = idx[:n_edges]
    return lo[idx], hi[idx]
