"""Halo-exchange node-sharded SpMM: collective traffic that follows the
edge cut, not N — the counterpart of `linkpred_tpu/parallel/halo.py`.

1. **Locality-aware ordering** (host): nodes are reordered (label
   propagation clusters, reverse Cuthill-McKee, or a degree-balanced deal),
   so that contiguous row blocks keep most of their edges inside.
2. **Ghost-row index** (host): for every shard pair (j -> k) the sorted
   unique rows of j that k's edges name, padded to the largest pair's count
   C; rows that many shards read can instead be replicated as hubs.
3. **Boundary-only exchange** (device): each rank gathers its send rows
   into `[S * C, F]`, one `all_to_all_single` delivers every rank exactly
   its ghost rows, one `all_gather` the hub rows (skipped when there are
   none), and kernel K3 aggregates over the local table `[own rows | S*C
   ghosts | S*H hubs]`.

`HaloLayout.build` and every field of the layout are the reference's host
numpy, array-equal to it. `spmm_halo_sym` adds the symmetric-adjacency
gradient (the same exchange and aggregation of the cotangent).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops.spmm import BucketedEll
from linkpred_tpu_torch.parallel.collectives import all_gather_blocks
from linkpred_tpu_torch.parallel.spmm_shard import (_stack_buckets,
                                                    shard_k3_operands)


def _label_prop_clusters(src, dst, n, rounds: int = 15,
                         seed: int = 0) -> np.ndarray:
    """Label propagation: each round a sampled 70 % of the nodes adopt the
    most frequent label among their neighbours (ties -> the smallest label,
    by the stable sort); partial updates avoid the two-colouring
    oscillation of synchronous propagation. The partitioner behind
    `HaloLayout`'s cluster ordering."""
    rng = np.random.default_rng(seed)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    labels = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        key = src * n + labels[dst]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        starts = np.flatnonzero(np.r_[True, np.diff(ks) != 0])
        counts = np.diff(np.r_[starts, len(ks)])
        run_src = ks[starts] // n
        run_lab = ks[starts] % n
        # per src, the run with the largest count (lexsort: the last wins)
        o2 = np.lexsort((counts, run_src))
        rs = run_src[o2]
        last = np.r_[np.flatnonzero(np.diff(rs) != 0), len(rs) - 1]
        best_src = rs[last]
        best_lab = run_lab[o2][last]
        upd = rng.random(len(best_src)) < 0.7
        new_labels = labels.copy()
        new_labels[best_src[upd]] = best_lab[upd]
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return labels


class HaloOperands(NamedTuple):
    """One rank's operands of `spmm_halo` on its device: the local rows it
    sends to each rank `send_idx` [S, C] int64, its hub rows `hub_send`
    [H] int64, and K3's operands over its local table (`inv_perm` = the
    layout's `out_inv` row, the buckets' slots concatenated)."""

    send_idx: torch.Tensor
    hub_send: torch.Tensor
    k3: tuple


@dataclasses.dataclass(frozen=True)
class HaloLayout:
    """Host-built layout for `spmm_halo` (see the module docstring).

    Node ids in `stacked` are LOCAL to their shard: [0, rows) is the
    shard's own block, [rows, rows + S*C) the ghost area (shard j's rows at
    rows + j*C) and [rows + S*C, rows + S*C + S*H) the hub area (owner j's
    hub rows at rows + S*C + j*H). The graph is relabelled by `order` (new
    id i is old node `order[i]`): callers map node ids through `inv_perm`
    (old -> new) and outputs back through `order`.

    Hub replication: rows read by at least `hub_min_refs` OTHER shards
    leave the pairwise exchange and reach every rank by one all-gather of
    each owner's hub rows. `"auto"` scores each threshold on the rows a
    rank receives, `S * (C + H)`, and keeps the cheapest (on graphs with
    locality usually no hubs)."""

    num_nodes: int
    n_shards: int
    rows_per_shard: int
    ghost_capacity: int  # C = most non-hub rows a shard needs from another
    order: np.ndarray  # [N] new position -> old node id
    inv_perm: np.ndarray  # [N] old node id -> new position
    send_idx: np.ndarray  # [S, S, C] shard-local rows j sends to k
    # per bucket: (ids [S, m], nbr_local [S, m, w], wgt [S, m, w])
    stacked: tuple
    pad_rows: int  # most bucket rows (diagnostic)
    edge_cut: int  # directed edges crossing shard blocks (diagnostic)
    hub_capacity: int = 0  # H = most hub rows one shard owns
    # [S, H] shard-local positions of each owner's hub rows (pad 0)
    hub_send: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((1, 1), np.int32))
    num_hubs: int = 0  # replicated rows in all (diagnostic)
    # [S, rows] local row -> row among the concatenated buckets (uncovered
    # rows -> the zero row one past the end)
    out_inv: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((1, 1), np.int32))

    def collective_bytes_per_layer(self, feats: int, dtype_bytes: int = 4):
        """Bytes a rank receives per aggregation: the pairwise ghost
        all-to-all plus the hub all-gather."""
        a2a = self.n_shards * self.ghost_capacity * feats * dtype_bytes
        ag = self.n_shards * self.hub_capacity * feats * dtype_bytes
        return a2a + ag

    @staticmethod
    def build(g, n_shards: int, reorder: bool | str = True,
              hub_min_refs: "int | None | str" = "auto",
              hub_budget: int | None = None,
              feats_hint: int = 128) -> "HaloLayout":
        """Build from a `data.graph.Graph`, as the reference does.

        `reorder`: `True` builds the cluster, RCM and balance layouts and
        keeps the one of least per-layer cost (padded aggregation slots
        plus ten times the collective bytes at `feats_hint` features);
        `"cluster"`, `"rcm"`, `"balance"` build that one; `False` keeps the
        input order. `hub_min_refs`: rows read by at least this many other
        shards become hubs (None: no hubs; `"auto"`: the cheapest
        threshold); `hub_budget` caps their count."""
        n = g.num_nodes

        def rcm_order():
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            ones = np.ones(len(g.src), np.int8)
            a = sp.csr_matrix((ones, (g.src, g.dst)), shape=(n, n))
            return np.asarray(
                reverse_cuthill_mckee(a + a.T, symmetric_mode=True),
                dtype=np.int64)

        def cluster_order():
            labels = _label_prop_clusters(g.src, g.dst, n)
            return np.argsort(labels, kind="stable").astype(np.int64)

        def balance_order():
            # degree-descending snake deal: each shard's degree profile is a
            # uniform sample of the whole graph's
            deg = np.asarray(g.nbr_mask.sum(axis=1))
            ranked = np.argsort(deg, kind="stable")[::-1]
            lane = np.arange(len(ranked)) % (2 * n_shards)
            shard = np.where(lane < n_shards, lane, 2 * n_shards - 1 - lane)
            order_ = np.concatenate(
                [ranked[shard == s] for s in range(n_shards)])
            return order_.astype(np.int64)

        def build_one(order_):
            return HaloLayout._build_for_order(
                g, order_, n_shards, hub_min_refs, hub_budget)

        def cost_of(lay: "HaloLayout"):
            slots = sum(
                lay.stacked[i + 1].shape[1] * lay.stacked[i + 1].shape[2]
                for i in range(0, len(lay.stacked), 3))
            return (slots * feats_hint * 4 * 2
                    + 10 * lay.collective_bytes_per_layer(feats_hint))

        if reorder == "rcm":
            return build_one(rcm_order())
        if reorder == "cluster":
            return build_one(cluster_order())
        if reorder == "balance":
            return build_one(balance_order())
        if not reorder:
            return build_one(np.arange(n, dtype=np.int64))
        return min((build_one(cluster_order()), build_one(rcm_order()),
                    build_one(balance_order())), key=cost_of)

    @staticmethod
    def _build_for_order(g, order, n_shards, hub_min_refs, hub_budget,
                         allow_redeal: bool = True):
        n = g.num_nodes
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)

        # relabelled ELL views
        nbr = inv[g.nbr[order]].astype(np.int32)
        mask = g.nbr_mask[order]
        wgt = g.nbr_weight[order] if g.nbr_weight is not None else None

        rows = -(-n // n_shards)

        def owner_of(ids):
            return ids // rows

        # pass 1: ghost needs per (receiver k, owner j) and each row's
        # reader fan-out (how many other shards name it)
        need = [[None] * n_shards for _ in range(n_shards)]
        cut = 0
        refs = np.zeros(n, np.int32)
        for k in range(n_shards):
            lo, hi = k * rows, min((k + 1) * rows, n)
            ids = nbr[lo:hi][mask[lo:hi]]
            own = owner_of(ids)
            cut += int((own != k).sum())
            for j in range(n_shards):
                if j == k:
                    continue
                uniq = np.unique(ids[own == j])
                need[k][j] = uniq
                refs[uniq] += 1

        def hub_set(mr):
            is_h = np.zeros(n, bool)
            if n_shards > 1 and mr is not None:
                cand = np.flatnonzero(refs >= mr)
                if hub_budget is not None and len(cand) > hub_budget:
                    top = np.argsort(
                        refs[cand], kind="stable")[::-1][:hub_budget]
                    cand = cand[top]
                is_h[cand] = True
            return is_h

        def volume(is_h):
            # rows a rank receives per layer: the pairwise exchange pads to
            # the largest residual need, every hub costs one all-gather row
            # on each of the S ranks (scored at the re-dealt hub_cap)
            cap_ = 1
            for k in range(n_shards):
                for j in range(n_shards):
                    if j != k:
                        cap_ = max(cap_, int((~is_h[need[k][j]]).sum()))
            hc = max(1, -(-int(is_h.sum()) // n_shards))
            return n_shards * (cap_ + hc)

        if hub_min_refs == "auto":
            cands = [None] + list(range(2, max(n_shards, 3)))
            is_hub = min((hub_set(mr) for mr in cands), key=volume)
        else:
            is_hub = hub_set(hub_min_refs)
        num_hubs = int(is_hub.sum())

        # ownership re-deal: a locality order concentrates the hubs in one
        # block; hub rows are read from the hub area, never from their
        # owner's block, so deal them round-robin over the blocks and
        # rebuild once
        if num_hubs and allow_redeal:
            owned = [int(is_hub[j * rows: (j + 1) * rows].sum())
                     for j in range(n_shards)]
            ideal = -(-num_hubs // n_shards)
            if max(owned) > ideal + max(2, ideal // 4):
                hub_new = np.flatnonzero(is_hub)
                non_new = np.flatnonzero(~is_hub)
                blocks, ptr = [], 0
                for b in range(n_shards):
                    hb = hub_new[b::n_shards]
                    take = rows - len(hb)
                    blocks.append(
                        np.concatenate([hb, non_new[ptr:ptr + take]]))
                    ptr += take
                perm2 = np.concatenate(blocks)[:n]
                return HaloLayout._build_for_order(
                    g, order[perm2], n_shards, hub_min_refs, hub_budget,
                    allow_redeal=False)

        # per-owner hub tables; hub_cap stays 0 when nothing is replicated
        # and `spmm_halo` then skips the all-gather
        hub_cap = 0
        hub_pos = np.zeros(n, np.int64)
        hub_local = []
        for j in range(n_shards):
            lo = j * rows
            ids = np.flatnonzero(is_hub[lo:lo + rows]) + lo
            hub_pos[ids] = np.arange(len(ids))
            hub_local.append(ids - lo)
            hub_cap = max(hub_cap, len(ids))
        hub_send = np.zeros((n_shards, hub_cap), np.int32)
        for j, ids in enumerate(hub_local):
            hub_send[j, : len(ids)] = ids

        # pass 2: the ghost capacity over the non-hub needs
        cap = 1
        for k in range(n_shards):
            for j in range(n_shards):
                if j == k:
                    continue
                need[k][j] = need[k][j][~is_hub[need[k][j]]]
                cap = max(cap, len(need[k][j]))

        send_idx = np.zeros((n_shards, n_shards, cap), np.int32)
        # per shard: new node id -> position in the local table
        remap = np.zeros((n_shards, rows * n_shards), np.int32)
        hub_base = rows + n_shards * cap
        for k in range(n_shards):
            m = np.zeros(rows * n_shards, np.int32)
            lo = k * rows
            m[lo:lo + rows] = np.arange(rows)
            other_hubs = is_hub.copy()
            other_hubs[lo:lo + rows] = False
            oh = np.flatnonzero(other_hubs)
            m[oh] = hub_base + owner_of(oh) * hub_cap + hub_pos[oh]
            for j in range(n_shards):
                if j == k:
                    continue
                ids = need[k][j]
                send_idx[j, k, : len(ids)] = ids - j * rows
                m[ids] = rows + j * cap + np.arange(len(ids))
            remap[k] = m

        per_shard = []
        for k in range(n_shards):
            lo, hi = k * rows, min((k + 1) * rows, n)
            nbr_k = remap[k][np.minimum(nbr[lo:hi], rows * n_shards - 1)]
            per_shard.append(
                BucketedEll.build(nbr_k, mask[lo:hi],
                                  wgt[lo:hi] if wgt is not None else None))
        widths = sorted({b[1].shape[1] for lay in per_shard
                         for b in lay.buckets})
        out_inv, stacked = _stack_buckets(per_shard, widths, n_shards, rows)
        pad_rows = max([1] + [stacked[i].shape[1]
                              for i in range(0, len(stacked), 3)])
        return HaloLayout(
            num_nodes=n, n_shards=n_shards, rows_per_shard=rows,
            ghost_capacity=cap, order=order, inv_perm=inv,
            send_idx=send_idx, stacked=tuple(stacked), pad_rows=pad_rows,
            edge_cut=cut, hub_capacity=hub_cap, hub_send=hub_send,
            num_hubs=num_hubs, out_inv=out_inv,
        )

    def operands(self, shard: int, device) -> HaloOperands:
        """Rank `shard`'s `HaloOperands` on `device`."""
        return HaloOperands(
            send_idx=torch.as_tensor(self.send_idx[shard], dtype=torch.long,
                                     device=device),
            hub_send=torch.as_tensor(self.hub_send[shard], dtype=torch.long,
                                     device=device),
            k3=shard_k3_operands(self.out_inv, self.stacked, shard, device))


def spmm_halo(group, x: torch.Tensor, ops: HaloOperands,
              exchange_dtype: torch.dtype | None = None) -> torch.Tensor:
    """This rank's block of `A x` in the layout's relabelled order, from its
    block `x` [r, F] (r <= rows_per_shard; a shorter last block is padded
    with zero rows): the ghost rows by one `all_to_all_single`, the hub
    rows by one `all_gather` (none when the layout has no hubs), then K3
    over `[own rows | ghosts | hubs]`. Returns [r, F] of `x.dtype`.

    `exchange_dtype` (e.g. torch.bfloat16) compresses only the payloads of
    the two collectives: boundary rows pass through one rounding, owned
    rows stay exact. No gradient; `spmm_halo_sym` has one."""
    rows = ops.k3[0].shape[0]
    r, f = x.shape
    if r < rows:
        x = torch.cat([x, x.new_zeros((rows - r, f))])
    xd = exchange_dtype or x.dtype
    send = x.index_select(0, ops.send_idx.reshape(-1)).to(xd)
    ghosts = torch.empty_like(send)
    dist.all_to_all_single(ghosts, send, group=group)
    parts = [x, ghosts.to(x.dtype)]
    if ops.hub_send.shape[0]:
        parts.append(all_gather_blocks(
            x.index_select(0, ops.hub_send).to(xd), group).to(x.dtype))
    out = hk.spmm_bucketed(torch.cat(parts).contiguous(), *ops.k3)
    return out[:r]


class _HaloSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ops, exchange_dtype):
        ctx.group, ctx.ops, ctx.xd = group, ops, exchange_dtype
        return spmm_halo(group, x, ops, exchange_dtype)

    @staticmethod
    def backward(ctx, g):
        # A^T = A, and the relabelling is a symmetric permutation; the
        # output has the primal block's rows, so dx mirrors its padding
        return (spmm_halo(ctx.group, g.contiguous(), ctx.ops, ctx.xd),
                None, None, None)


def spmm_halo_sym(group, x: torch.Tensor, ops: HaloOperands,
                  exchange_dtype: torch.dtype | None = None) -> torch.Tensor:
    """`spmm_halo` with the symmetric-adjacency gradient: for w_ij = w_ji
    the backward is the same exchange and K3 aggregation of the cotangent.
    Input and output are this rank's block of rows."""
    return _HaloSym.apply(x, group, ops, exchange_dtype)
