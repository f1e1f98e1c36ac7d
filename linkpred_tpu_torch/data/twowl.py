"""TwoWL data path: doubled directed edges, splits, and the ei2 edge-pair
incidence structure — all static-shaped.

The port's own copy of `linkpred_tpu/data/twowl.py` (numpy only, same names
and behaviour; the port imports nothing of the JAX package).

Behavioral contract from the reference (`TwoWL/operators/datasets.py`,
`TwoWL/utils.py`):

- Every undirected pair k becomes two directed edges at indices 2k (u->v)
  and 2k+1 (v->u) — the "doubling" convention (`utils.py:81-90`). An edge's
  reverse partner is then index XOR 1 (`reverse`, `utils.py:71-78`).
- Splits: shuffled 85/5/10 positive split + dense-mask val/test negatives +
  uniform train negatives (`utils.py:93-147`, `datasets.py:171-197`) — we
  reuse `linkpred_tpu_torch.data.split.random_split_edges` for this.
- Per split i in {train, val, test}: message edges `ei` (train pos for
  0/1, train+val pos for 2), prediction edges (train neg for 0, pos+neg
  for 1/2), `pos1` = message ++ prediction pair list, labels, and
  `ei2` = the 2-WL edge-pair graph (`datasets.py:44-101`).
- `get_ei2` (`utils.py:36-45`): for every node n, the cartesian product of
  {message-edge indices a with dst(a)=n} x {any-edge indices b with
  src(b)=n} — i.e. message edge a feeds edge b through their shared node.
  The reference builds this with a per-node Python loop of `set_mul`
  tensors; here it is one vectorized CSR-style expansion (repeat/tile by
  per-node counts), identical output order (node-major, row-major within
  a node).

Static-shape redesign: `sample_block` (`utils.py:60-68`), which *physically
removes* sampled target edges from the message graph and filters ei2 — a
data-dependent-shape operation — becomes **mask arithmetic** over the static
arrays (see `linkpred_tpu_torch.models.twowl.sample_block_masks`): weights of
removed edges go to 0, degrees are recomputed by masked segment-sum, and
ei2 columns whose source edge is removed are masked. Shapes never change.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from linkpred_tpu_torch.data import split as sp


def double_pairs(pairs: np.ndarray) -> np.ndarray:
    """[M, 2] undirected pairs -> [2M, 2] directed, interleaved 2k/2k+1
    (reference `double`, `utils.py:81-90`)."""
    p = np.asarray(pairs, dtype=np.int32)
    out = np.empty((2 * len(p), 2), dtype=np.int32)
    out[0::2] = p
    out[1::2] = p[:, ::-1]
    return out


def build_ei2(
    num_nodes: int, msg: np.ndarray, pred: np.ndarray
) -> np.ndarray:
    """Vectorized `get_ei2`: [S, 2] (a, b) with a a message-edge index and
    b an index into msg ++ pred, sharing dst(a) == src(b).

    One CSR-style expansion instead of the reference's per-node loop
    (`utils.py:36-45`); output ordering matches (node-major, then
    row-major over the per-node cartesian product).
    """
    msg = np.asarray(msg, dtype=np.int64)
    allE = np.concatenate([msg, np.asarray(pred, dtype=np.int64)], axis=0)

    in_order = np.argsort(msg[:, 1], kind="stable")
    in_counts = np.bincount(msg[:, 1], minlength=num_nodes)
    in_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(in_counts, out=in_ptr[1:])

    out_order = np.argsort(allE[:, 0], kind="stable")
    out_counts = np.bincount(allE[:, 0], minlength=num_nodes)
    out_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(out_counts, out=out_ptr[1:])

    counts = in_counts * out_counts
    starts = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    S = int(starts[-1])
    if S == 0:
        return np.zeros((0, 2), dtype=np.int32)

    node = np.repeat(np.arange(num_nodes), counts)
    local = np.arange(S, dtype=np.int64) - starts[node]
    a_local = local // np.maximum(out_counts[node], 1)
    b_local = local % np.maximum(out_counts[node], 1)
    a = in_order[in_ptr[node] + a_local]
    b = out_order[out_ptr[node] + b_local]
    return np.stack([a, b], axis=1).astype(np.int32)


def build_ei2_capped(
    num_nodes: int,
    msg: np.ndarray,
    pred: np.ndarray,
    cap_per_node: int,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """`build_ei2` with a per-node budget: a node whose in(msg) x out(all)
    cartesian product exceeds `cap_per_node` contributes a uniform random
    subset of its products instead — the same capacity-bounding move the
    reference applies to SEAL subgraphs (`SEAL/config/subgraph.py:118-131`,
    `max_neighbors` random truncation), carried to the 2-WL ei2 structure
    so LocalWLNet trains on graphs where Σ deg_in·deg_out is intractable.
    Uncapped nodes emit exactly their `build_ei2` products (same order).
    """
    rng = rng or np.random.default_rng(0)
    msg = np.asarray(msg, dtype=np.int64)
    allE = np.concatenate([msg, np.asarray(pred, dtype=np.int64)], axis=0)

    in_order = np.argsort(msg[:, 1], kind="stable")
    in_counts = np.bincount(msg[:, 1], minlength=num_nodes)
    in_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(in_counts, out=in_ptr[1:])

    out_order = np.argsort(allE[:, 0], kind="stable")
    out_counts = np.bincount(allE[:, 0], minlength=num_nodes)
    out_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(out_counts, out=out_ptr[1:])

    counts = in_counts * out_counts
    kept = np.minimum(counts, cap_per_node)
    starts = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(kept, out=starts[1:])
    S = int(starts[-1])
    if S == 0:
        return np.zeros((0, 2), dtype=np.int32)

    node = np.repeat(np.arange(num_nodes), kept)
    prod = np.arange(S, dtype=np.int64) - starts[node]
    # hubs only: replace the leading-cap product ids by a uniform subset
    for v in np.flatnonzero(counts > cap_per_node):
        prod[starts[v]: starts[v] + cap_per_node] = np.sort(
            rng.choice(counts[v], cap_per_node, replace=False))
    a_local = prod // np.maximum(out_counts[node], 1)
    b_local = prod % np.maximum(out_counts[node], 1)
    a = in_order[in_ptr[node] + a_local]
    b = out_order[out_ptr[node] + b_local]
    return np.stack([a, b], axis=1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class TwoWLSplit:
    """Static arrays for one split of the 2-WL pipeline.

    msg: [Em, 2] directed message edges (doubled positives; order defines
       the XOR-partner convention, so it is never reordered).
    msg_perm: [Em] argsort of msg dst — the 1-WL scatter runs over this
       permutation with `indices_are_sorted=True`.
    pred: [Ep, 2] directed prediction edges (doubled).
    pos1: [Em+Ep, 2] = msg ++ pred — rows of the edge-level (2-WL) graph.
    y: [Ep/2] labels per undirected prediction pair (split 0 keeps the
       reference convention that train positives are scored out of `msg`).

    The ei2 edge-pair columns are stored twice, once per propagation
    direction, each presorted by its scatter destination (capacity pads
    carry dst = num rows and sort last; segment_sum drops them):
    e1: messages row (a XOR 1) -> row b        (reference `edge2`)
    e2: messages row a -> row (b XOR 1)        (reference `edge_r`)
    e*_src holds the *message-edge id a* (the dynamic sample-block mask
    tests `msg_mask[a]`); the dir-1 source row is a XOR 1, applied in the
    model. e*_dst is the final scatter destination.
    """

    msg: np.ndarray
    msg_perm: np.ndarray
    pred: np.ndarray
    pos1: np.ndarray
    y: np.ndarray
    e1_src: np.ndarray
    e1_dst: np.ndarray
    e1_mask: np.ndarray
    e2_src: np.ndarray
    e2_dst: np.ndarray
    e2_mask: np.ndarray
    num_nodes: int

    @property
    def num_msg(self) -> int:
        return len(self.msg)

    @property
    def num_rows(self) -> int:
        return len(self.pos1)


@dataclasses.dataclass(frozen=True)
class TwoWLData:
    train: TwoWLSplit
    val: TwoWLSplit
    test: TwoWLSplit
    node_deg: np.ndarray  # [N] train-positive in-degrees (the node feature)
    max_degree: int
    num_nodes: int


def _sorted_direction(
    a: np.ndarray, dst: np.ndarray, mask: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort columns by scatter destination (pads already carry dst = R)."""
    p = np.argsort(dst, kind="stable")
    return a[p], dst[p], mask[p]


def _pad_and_sort_ei2(
    ei2: np.ndarray, capacity: int, num_rows: int
) -> tuple[tuple, tuple]:
    """Capacity-pad the ei2 columns and produce the two direction-sorted
    views (see TwoWLSplit docstring). Pads get dst = num_rows, which sorts
    last and is dropped by segment_sum."""
    s = len(ei2)
    if capacity < s:
        raise ValueError(f"ei2 capacity {capacity} < actual {s}")
    pad = capacity - s
    a = np.concatenate([ei2[:, 0], np.zeros(pad, dtype=np.int64)]).astype(np.int32)
    b = np.concatenate([ei2[:, 1], np.zeros(pad, dtype=np.int64)]).astype(np.int32)
    mask = np.zeros(capacity, dtype=bool)
    mask[:s] = True
    d1 = np.where(mask, b, num_rows).astype(np.int32)
    d2 = np.where(mask, b ^ 1, num_rows).astype(np.int32)
    return _sorted_direction(a, d1, mask), _sorted_direction(a, d2, mask)


def _round_capacity(s: int, bucket: int = 4096) -> int:
    return ((s + bucket - 1) // bucket) * bucket if s else bucket


def build_twowl_data(
    pairs: np.ndarray,
    num_nodes: int,
    rng: np.random.Generator | None = None,
    val_ratio: float = 0.05,
    test_ratio: float = 0.1,
    ei2_bucket: int = 4096,
    ei2_cap_per_node: int | None = None,
) -> TwoWLData:
    """Assemble all three splits from an undirected pair list.

    Mirrors `BaseGraph.preprocess` (`datasets.py:44-101`): message edges are
    train positives (train+val positives for the test split); prediction
    edges are train negatives (split 0) or the split's pos++neg (1/2).
    ei2 arrays are capacity-padded to `ei2_bucket` multiples so repeated
    dataset rebuilds (the sweep loop's 10% resample) rarely change shapes
    and therefore rarely recompile.

    `ei2_cap_per_node` switches the ei2 build to the capacity-bounded
    sampler (`build_ei2_capped`) — the scale path for graphs where the
    full Σ deg_in·deg_out structure is intractable.
    """
    rng = rng or np.random.default_rng(0)
    es = sp.random_split_edges(
        pairs, num_nodes, val_ratio=val_ratio, test_ratio=test_ratio, rng=rng
    )

    train_pos = double_pairs(es.train_pos)
    train_neg = double_pairs(es.train_neg)
    val_pos = double_pairs(es.val_pos)
    val_neg = double_pairs(es.val_neg)
    test_pos = double_pairs(es.test_pos)
    test_neg = double_pairs(es.test_neg)

    msg01 = train_pos
    msg2 = np.concatenate([train_pos, val_pos], axis=0)

    pred0 = train_neg
    pred1 = np.concatenate([val_pos, val_neg], axis=0)
    pred2 = np.concatenate([test_pos, test_neg], axis=0)

    def make(msg, pred, y):
        if ei2_cap_per_node is not None:
            ei2 = build_ei2_capped(num_nodes, msg, pred, ei2_cap_per_node,
                                   rng)
        else:
            ei2 = build_ei2(num_nodes, msg, pred)
        cap = _round_capacity(len(ei2), ei2_bucket)
        num_rows = len(msg) + len(pred)
        (e1_src, e1_dst, e1_mask), (e2_src, e2_dst, e2_mask) = _pad_and_sort_ei2(
            ei2, cap, num_rows
        )
        return TwoWLSplit(
            msg=msg,
            msg_perm=np.argsort(msg[:, 1], kind="stable").astype(np.int32),
            pred=pred,
            pos1=np.concatenate([msg, pred], axis=0),
            y=y,
            e1_src=e1_src,
            e1_dst=e1_dst,
            e1_mask=e1_mask,
            e2_src=e2_src,
            e2_dst=e2_dst,
            e2_mask=e2_mask,
            num_nodes=num_nodes,
        )

    y0 = np.zeros(len(pred0) // 2, dtype=np.float32)
    y1 = np.concatenate(
        [np.ones(len(val_pos) // 2), np.zeros(len(val_neg) // 2)]
    ).astype(np.float32)
    y2 = np.concatenate(
        [np.ones(len(test_pos) // 2), np.zeros(len(test_neg) // 2)]
    ).astype(np.float32)

    train = make(msg01, pred0, y0)
    val = make(msg01, pred1, y1)
    test = make(msg2, pred2, y2)

    # Node feature = degree under the *train* message graph for every split
    # (reference `setPosDegreeFeature`, `datasets.py:107-114`, indexes
    # edge_indexs[0]/[1], both of which are the train positives). The
    # embedding table is sized by this maximum; masked-batch degrees during
    # training can only be smaller.
    deg = np.bincount(msg01[:, 1], minlength=num_nodes).astype(np.int32)
    return TwoWLData(
        train=train,
        val=val,
        test=test,
        node_deg=deg,
        max_degree=int(deg.max(initial=0)),
        num_nodes=num_nodes,
    )
