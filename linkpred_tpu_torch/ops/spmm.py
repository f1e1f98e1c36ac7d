"""Sparse x dense aggregation (SpMM) — the counterpart of the single-card
part of `linkpred_tpu/ops/spmm.py`. All compute `out[i] = sum_{j in N(i)}
w_ij * x[j]`:

- COO + segment sum (`spmm_coo`), with per-edge weights and a validity mask,
  and the symmetric-normalised `gcn_aggregate` on it;
- flat ELL gather-sum (`spmm_ell`, `spmm_ell_blocked`) in plain PyTorch;
- degree-bucketed ELL (`BucketedEll`, `spmm_bucketed`, `spmm_bucketed_sym`)
  on kernel K3;
- `spmm_auto`, the reference's regime dispatch: 'bucketed' (K3), 'ell'
  (plain) or, when forced, 'pallas', which is K1 here
  (`hopper_kernels.spmm_ell_auto`).

`BucketedEll.build` is the reference's host builder, re-implemented (that
module imports jax) and array-equal to it. `operands(device)` flattens the
buckets into the layout of kernel K3 (`csrc/spmm_bucketed.cu`): one `nbr`
and one weight array over all buckets, the `(rows, width)` of each bucket,
and `inv_perm`. `spmm_bucketed` runs K3 on CUDA tensors and its plain
version on CPU tensors (`hopper_kernels.spmm_bucketed`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops.segment import gcn_norm_coefficients, segment_sum

# graphs of more rows than this take the bucketed regime in `spmm_auto` (the
# reference's switch point)
BUCKETED_MIN_NODES = 16384


def spmm_coo(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
             num_nodes: int, edge_weight: torch.Tensor | None = None,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """out[dst] += w * x[src] over the (masked) edges: [num_nodes, F]."""
    msgs = x[src.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    return segment_sum(msgs, dst, num_nodes, mask)


def spmm_ell(nbr: torch.Tensor, nbr_mask: torch.Tensor, x: torch.Tensor,
             nbr_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ELL aggregation: out[i] = sum_d mask[i, d] * w[i, d] *
    x[nbr[i, d]] for `nbr` [N, D], `nbr_mask` [N, D] bool, x [NX, F]."""
    w = nbr_mask.to(x.dtype)
    if nbr_weight is not None:
        w = w * nbr_weight
    return torch.einsum("nd,ndf->nf", w, x[nbr.long()])


def spmm_ell_blocked(nbr: torch.Tensor, nbr_mask: torch.Tensor,
                     x: torch.Tensor, nbr_weight: torch.Tensor | None = None,
                     block_rows: int = 4096) -> torch.Tensor:
    """`spmm_ell` a block of `block_rows` rows at a time, which bounds the
    [block, D, F] gathered rows of large graphs."""
    return torch.cat([
        spmm_ell(nbr[s: s + block_rows], nbr_mask[s: s + block_rows], x,
                 None if nbr_weight is None else nbr_weight[s: s + block_rows])
        for s in range(0, nbr.shape[0], block_rows)]
        or [x.new_zeros((0, x.shape[1]))])


def gcn_aggregate(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
                  num_nodes: int, mask: torch.Tensor | None = None,
                  add_self_loops: bool = True) -> torch.Tensor:
    """Symmetric-normalised GCN propagation over an edge index, `D^-1/2 (A +
    I) D^-1/2 x` with degrees from the (masked) edges: the aggregation of
    PyG's `GCNConv`."""
    coeff, self_coeff = gcn_norm_coefficients(
        src, dst, num_nodes, mask=mask, add_self_loops=add_self_loops)
    out = spmm_coo(src, dst, x, num_nodes, edge_weight=coeff, mask=mask)
    if add_self_loops:
        out = out + self_coeff[:, None] * x
    return out


def width_ladder(max_width: int, min_width: int = 2) -> list[int]:
    """Bucket widths {2^k, 3·2^(k-1)} from `min_width` up to `max_width`:
    each step grows at most 1.5x, so padded slots stay within 1.5x of the
    edges (the reference's ladder, `ops/spmm.py:151-167`)."""
    widths = []
    width = max(1, min_width)
    while True:
        widths.append(min(width, max_width))
        if width >= max_width:
            return widths
        if width < 4:
            width *= 2  # 1, 2, 4
        elif width & (width - 1) == 0:
            width = width * 3 // 2  # 4 -> 6, 8 -> 12, 16 -> 24, ...
        else:
            width = width * 4 // 3  # 6 -> 8, 12 -> 16, 24 -> 32, ...


@dataclasses.dataclass(frozen=True)
class BucketedEll:
    """Nodes grouped by degree into sub-ELLs of the widths of
    `width_ladder`, built once on the host (numpy), as in the reference.

    `buckets` holds, per non-empty bucket, `(row_ids [n_b] int32,
    nbr [n_b, w_b] int32, weight [n_b, w_b] float32)`; `inv_perm` [N] int32
    maps each node to its row in the concat of the buckets, and degree-0
    nodes to one zero row past the end."""

    num_nodes: int
    num_edges: int
    buckets: tuple[tuple[np.ndarray, np.ndarray, np.ndarray], ...]
    inv_perm: np.ndarray = None

    @staticmethod
    def build(nbr: np.ndarray, nbr_mask: np.ndarray,
              nbr_weight: np.ndarray | None = None,
              min_width: int = 2) -> "BucketedEll":
        nbr = np.asarray(nbr)
        mask = np.asarray(nbr_mask)
        n, d = nbr.shape
        deg = mask.sum(axis=1).astype(np.int64)
        w = mask.astype(np.float32)
        if nbr_weight is not None:
            w = w * np.asarray(nbr_weight, dtype=np.float32)
        buckets = []
        prev = 0
        inv_perm = np.full(n, -1, dtype=np.int64)
        off = 0
        for wd in width_ladder(d, min_width):
            ids = np.where((deg > prev) & (deg <= wd))[0].astype(np.int32)
            prev = wd
            if len(ids) == 0:
                continue
            buckets.append((ids, nbr[ids, :wd].copy(), w[ids, :wd].copy()))
            inv_perm[ids] = off + np.arange(len(ids))
            off += len(ids)
        inv_perm[inv_perm < 0] = off  # degree-0 rows -> the zero row
        return BucketedEll(num_nodes=n, num_edges=int(deg.sum()),
                           buckets=tuple(buckets),
                           inv_perm=inv_perm.astype(np.int32))

    @staticmethod
    def from_graph(g) -> "BucketedEll":
        """Layout for `out[i] = sum_j w_ij x[nbr_ij]` over a `Graph`'s ELL
        view (`linkpred_tpu_torch.data.graph.Graph`)."""
        return BucketedEll.build(g.nbr, g.nbr_mask, g.nbr_weight)

    @property
    def num_slots(self) -> int:
        return sum(nb.size for _, nb, _ in self.buckets)

    def operands(self, device) -> tuple:
        """K3's layout on `device`: `(inv_perm [N] int32, bucket_shapes,
        nbr [S] int32, weight [S] float32)`, the buckets' rows concatenated
        in order; `bucket_shapes` is a host tuple of `(rows, width)`. K3's
        optional launch order is left out: a graph's rows are many times
        the warps the card holds at once and at most `max_degree` wide, so
        the kernel takes them in row order."""
        shapes = tuple((int(nb.shape[0]), int(nb.shape[1]))
                       for _, nb, _ in self.buckets)
        nbr = np.concatenate([nb.reshape(-1) for _, nb, _ in self.buckets]
                             or [np.zeros(0, np.int32)])
        w = np.concatenate([wb.reshape(-1) for _, _, wb in self.buckets]
                           or [np.zeros(0, np.float32)])

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
                device)

        return (dev(self.inv_perm, np.int32), shapes, dev(nbr, np.int32),
                dev(w, np.float32))


def _check_rows(operands: tuple, num_nodes: int) -> None:
    if operands[0].shape[0] != num_nodes:
        raise ValueError(f"layout has {operands[0].shape[0]} rows, "
                         f"num_nodes is {num_nodes}")


def spmm_bucketed(x: torch.Tensor, num_nodes: int, *operands) -> torch.Tensor:
    """out[i] = sum_d w[i, d] * x[nbr[i, d]] over a `BucketedEll` layout;
    `operands` is `BucketedEll.operands(device)` splatted. Weights are
    rounded to `x.dtype`, sums are f32, the result is `x.dtype` [N, F] and
    0 on degree-0 rows."""
    _check_rows(operands, num_nodes)
    return hk.spmm_bucketed(x, *operands)


class _SymmetricAggregation(torch.autograd.Function):
    """`aggregate(x, *operands)` whose backward is the same aggregation of
    the cotangent: right when the weighted adjacency is symmetric."""

    @staticmethod
    def forward(ctx, x, aggregate, operands):
        ctx.aggregate, ctx.operands = aggregate, operands
        return aggregate(x, *operands)

    @staticmethod
    def backward(ctx, g):
        return ctx.aggregate(g.contiguous(), *ctx.operands), None, None


def spmm_bucketed_sym(x: torch.Tensor, num_nodes: int,
                      operands: tuple) -> torch.Tensor:
    """`spmm_bucketed` with the symmetric-adjacency gradient of the
    reference's custom VJP: for w_ij = w_ji, d/dx (A x)^T g = A g, so the
    backward is the same kernel on the cotangent. Correct only for a
    symmetric pattern and weights (`Graph.with_degree_cap(...,
    symmetric=True)` and the symmetric GCN normalisation)."""
    _check_rows(operands, num_nodes)
    return _SymmetricAggregation.apply(x, hk.spmm_bucketed, operands)


def spmm_bucketed_sym_reference(x: torch.Tensor, num_nodes: int,
                                operands: tuple) -> torch.Tensor:
    """`spmm_bucketed_sym` on the plain version of K3 on any device: what a
    run on the card is compared with."""
    _check_rows(operands, num_nodes)
    return _SymmetricAggregation.apply(x, hk.spmm_bucketed_reference,
                                       operands)


def spmm_auto(nbr, nbr_mask, x: torch.Tensor, nbr_weight=None,
              force: str | None = None) -> torch.Tensor:
    """Whole-graph SpMM with the reference's host-side regime choice:

    - 'bucketed': builds a `BucketedEll` on the host (`nbr`, `nbr_mask` and
      `nbr_weight` are then numpy or host tensors) and runs K3 on `x`'s
      device; the default above `BUCKETED_MIN_NODES` rows. Loops should
      build the layout once and call `spmm_bucketed`.
    - 'ell': the plain flat ELL gather-sum; the default below.
    - 'pallas' (forced only): K1 (`hopper_kernels.spmm_ell_auto`), f32."""
    n = nbr.shape[0]
    regime = force or ("bucketed" if n > BUCKETED_MIN_NODES else "ell")

    def dev(a):
        return None if a is None else torch.as_tensor(a, device=x.device)

    if regime == "pallas":
        return hk.spmm_ell_auto(dev(nbr), dev(nbr_mask), x, dev(nbr_weight))
    if regime == "bucketed":
        lay = BucketedEll.build(
            np.asarray(nbr), np.asarray(nbr_mask),
            None if nbr_weight is None else np.asarray(nbr_weight))
        return spmm_bucketed(x, lay.num_nodes, *lay.operands(x.device))
    if regime == "ell":
        return spmm_ell(dev(nbr), dev(nbr_mask), x, dev(nbr_weight))
    raise ValueError(f"spmm_auto: unknown regime {regime!r}")
