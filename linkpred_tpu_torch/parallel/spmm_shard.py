"""Edge- and node-partitioned sparse aggregation over a mesh dim — the
counterpart of `linkpred_tpu/parallel/spmm_shard.py`.

- `spmm_edge_partitioned`: each rank sums its shard of the edge list into a
  full-height partial `[N, F]`; one `all_reduce` over the dim's group adds
  the partials (the reference's `psum` over ``edge``).
- `spmm_node_sharded` and `_sym`: each rank owns a contiguous block of
  `rows_per_shard` output rows and aggregates it with kernel K3
  (`ops.hopper_kernels.spmm_bucketed`) from the replicated `x`, gathering
  with global neighbour ids; the output is this rank's block. The layout is
  `build_node_sharded_buckets`, array-equal to the reference's host builder,
  and `node_sharded_operands` turns one shard of it into K3's operands.
- `spmm_node_sharded_pipelined`: `x` row-sharded; each feature stripe's
  all-gather is started asynchronously and runs while K3 aggregates the
  stripe before it.

The reference computes the per-shard aggregation as a gather and an einsum
inside `shard_map` (`spmm_shard.py:154-167`); here it is K3, on the card, or
its plain version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops.spmm import BucketedEll, spmm_coo
from linkpred_tpu_torch.parallel.collectives import (all_gather_blocks,
                                                     all_gather_single,
                                                     all_reduce_sum,
                                                     grad_all_reduce)


def spmm_edge_partitioned(group, src: torch.Tensor, dst: torch.Tensor,
                          x: torch.Tensor, num_nodes: int,
                          edge_weight: torch.Tensor | None = None,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = sum_{e: dst_e = i} w_e x[src_e] over every rank's edges.

    `src`, `dst`, `edge_weight`, `mask` are this rank's shard of the edge
    list (`pad_edges_for_mesh`, then `mesh.data_sharding` over the dim);
    `x` [N, F] and the output are replicated. The gradient of `x` is the
    sum of the ranks' partial transposes."""
    part = spmm_coo(src, dst, grad_all_reduce(x, group), num_nodes,
                    edge_weight=edge_weight, mask=mask)
    return all_reduce_sum(part, group)


def pad_edges_for_mesh(arrs, axis_size: int, pad_value=0):
    """Pad 1-D edge arrays (numpy or tensors) to a multiple of the mesh
    dim's size; returns (padded arrays, valid mask)."""
    e = arrs[0].shape[0]
    target = -(-e // axis_size) * axis_size
    pad = target - e
    if isinstance(arrs[0], torch.Tensor):
        out = [torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]),
                                        pad_value)]) for a in arrs]
        return out, torch.arange(target, device=arrs[0].device) < e
    out = [np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                  constant_values=pad_value) for a in arrs]
    return out, np.arange(target) < e


def build_node_sharded_buckets(g, n_shards: int):
    """Host layout for `spmm_node_sharded`: contiguous blocks of
    `rows = ceil(N / n_shards)` nodes, each with its own degree-bucketed ELL
    (`ops.spmm.BucketedEll`), the bucket arrays padded to equal shapes
    across shards and stacked on a leading shard axis. Padding rows point
    past the block (row `rows + j`).

    Returns `(rows_per_shard, bucket_widths, stacked)`, `stacked` a flat
    tuple of numpy arrays: first `out_inv` [S, rows] (each local row's row
    among the concatenated buckets, uncovered rows -> one past the end,
    the zero row), then per bucket `(ids [S, m], nbr [S, m, w],
    wgt [S, m, w])`. Array-equal to the reference's."""
    n = g.num_nodes
    rows = -(-n // n_shards)
    per_shard = []
    for k in range(n_shards):
        lo, hi = k * rows, min((k + 1) * rows, n)
        w = g.nbr_weight[lo:hi] if g.nbr_weight is not None else None
        per_shard.append(BucketedEll.build(g.nbr[lo:hi], g.nbr_mask[lo:hi], w))
    widths = sorted({nb.shape[1] for lay in per_shard
                     for _, nb, _ in lay.buckets})
    out_inv, stacked = _stack_buckets(per_shard, widths, n_shards, rows)
    return rows, widths, (out_inv,) + tuple(stacked)


def _stack_buckets(per_shard, widths, n_shards: int, rows: int):
    """The shards' buckets padded to common shapes per width and stacked,
    and `out_inv` [S, rows] int32 (shared with `halo.HaloLayout`)."""
    stacked = []
    out_inv = np.full((n_shards, rows), -1, np.int64)
    offset = 0
    for wd in widths:
        sizes = [next((b[0].shape[0] for b in lay.buckets
                       if b[1].shape[1] == wd), 0) for lay in per_shard]
        m_max = max(max(sizes), 1)
        ids_s = np.zeros((n_shards, m_max), np.int32)
        nbr_s = np.zeros((n_shards, m_max, wd), np.int32)
        wgt_s = np.zeros((n_shards, m_max, wd), np.float32)
        for k, lay in enumerate(per_shard):
            b = next((b for b in lay.buckets if b[1].shape[1] == wd), None)
            m = 0
            if b is not None:
                ids, nb, wg = b
                m = ids.shape[0]
                ids_s[k, :m] = ids
                nbr_s[k, :m] = nb
                wgt_s[k, :m] = wg
                out_inv[k, ids] = offset + np.arange(m)
            # padding rows target rows beyond the block: unique and sorted
            ids_s[k, m:] = rows + np.arange(m_max - m, dtype=np.int32)
        offset += m_max
        stacked.extend((ids_s, nbr_s, wgt_s))
    out_inv[out_inv < 0] = offset
    return out_inv.astype(np.int32), stacked


def shard_k3_operands(out_inv: np.ndarray, buckets, shard: int,
                      device) -> tuple:
    """K3's operands for shard `shard` of a stacked layout: `(inv_perm
    [rows] int32, bucket_shapes, nbr [slots] int32, weight [slots]
    float32)`, the shard's buckets concatenated in order. A padding row
    has weight 0 everywhere and adds nothing."""
    nbrs = [buckets[i + 1][shard] for i in range(0, len(buckets), 3)]
    wgts = [buckets[i + 2][shard] for i in range(0, len(buckets), 3)]
    shapes = tuple((int(nb.shape[0]), int(nb.shape[1])) for nb in nbrs)
    flat_nbr = np.concatenate([nb.reshape(-1) for nb in nbrs]
                              or [np.zeros(0, np.int32)])
    flat_w = np.concatenate([w.reshape(-1) for w in wgts]
                            or [np.zeros(0, np.float32)])

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return (dev(out_inv[shard], np.int32), shapes, dev(flat_nbr, np.int32),
            dev(flat_w, np.float32))


def node_sharded_operands(stacked, shard: int, device) -> tuple:
    """K3's operands of shard `shard` of `build_node_sharded_buckets(...)[2]`
    on `device`."""
    return shard_k3_operands(stacked[0], stacked[1:], shard, device)


def spmm_node_sharded(group, x: torch.Tensor, num_nodes: int,
                      rows_per_shard: int, ops: tuple) -> torch.Tensor:
    """This rank's block of `A x`: [rows_per_shard, F] of `x.dtype` (rows
    past `num_nodes` are zero), from the replicated `x` [N, F] on K3 with
    `ops = node_sharded_operands(stacked, rank, device)`. No gradient;
    `spmm_node_sharded_sym` has one."""
    del group, num_nodes
    if ops[0].shape[0] != rows_per_shard:
        raise ValueError(f"operands cover {ops[0].shape[0]} rows, "
                         f"rows_per_shard is {rows_per_shard}")
    return hk.spmm_bucketed(x.contiguous(), *ops)


class _NodeShardedSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rows, ops):
        ctx.group, ctx.rows, ctx.ops, ctx.n = group, rows, ops, x.shape[0]
        return hk.spmm_bucketed(x.contiguous(), *ops)

    @staticmethod
    def backward(ctx, g):
        g_full = all_gather_blocks(g.contiguous(), ctx.group)
        dx_own = hk.spmm_bucketed(g_full, *ctx.ops)
        lo = dist.get_rank(ctx.group) * ctx.rows
        hi = min(lo + ctx.rows, ctx.n)
        dx = dx_own.new_zeros((ctx.n, dx_own.shape[1]))
        dx[lo:hi] = dx_own[: hi - lo]
        return dx, None, None, None


def spmm_node_sharded_sym(group, x: torch.Tensor, num_nodes: int,
                          rows_per_shard: int, ops: tuple) -> torch.Tensor:
    """`spmm_node_sharded` with the symmetric-adjacency gradient of the
    reference's custom VJP: for w_ij = w_ji, the gradient `A^T g = A g` is
    the same sharded aggregation of the cotangent, all-gathered from the
    ranks' blocks. The gradient of the replicated `x` comes back whole on
    this rank's block and zero elsewhere (`collectives`' convention: the
    ranks' blocks together are the whole gradient)."""
    if ops[0].shape[0] != rows_per_shard:
        raise ValueError(f"operands cover {ops[0].shape[0]} rows, "
                         f"rows_per_shard is {rows_per_shard}")
    del num_nodes
    return _NodeShardedSym.apply(x, group, rows_per_shard, ops)


def spmm_node_sharded_pipelined(group, x: torch.Tensor, num_nodes: int,
                                rows_per_shard: int, ops: tuple,
                                chunks: int = 4) -> torch.Tensor:
    """`spmm_node_sharded` from a ROW-SHARDED `x` (this rank's block,
    [rows_per_shard, F]) with the all-gather overlapped: the aggregation is
    linear in the features, so each of `chunks` feature stripes needs only
    its own columns of every block. Each stripe's all-gather is started
    (`async_op=True`) before K3 runs on the stripe before it. `chunks=1` is
    the no-overlap form (one gather, then K3). Returns this rank's block of
    `A x`, [rows_per_shard, F]. No gradient."""
    del num_nodes
    f = x.shape[1]
    if f % chunks:
        raise ValueError(f"{f} features do not split into {chunks} stripes")
    if x.shape[0] != rows_per_shard:
        raise ValueError(f"x has {x.shape[0]} rows, rows_per_shard is "
                         f"{rows_per_shard}")
    fc, s = f // chunks, dist.get_world_size(group)

    def start(c):
        stripe = x[:, c * fc:(c + 1) * fc].contiguous()
        buf = stripe.new_empty((s * rows_per_shard, fc))
        return buf, all_gather_single(buf, stripe, group=group,
                                      async_op=True)

    pending, outs = start(0), []
    for c in range(chunks):
        buf, work = pending
        if c + 1 < chunks:
            pending = start(c + 1)
        work.wait()
        outs.append(hk.spmm_bucketed(buf, *ops))
    return torch.cat(outs, dim=1)
