"""Per-edge products of endpoint features — the counterpart of
`linkpred_tpu/ops/sddmm.py`. `sddmm_coo` runs kernel K2 (`csrc/sddmm.cu`)
forward and its gradient kernel backward on CUDA tensors, and their plain
versions on CPU tensors (`hopper_kernels.sddmm`, `sddmm_grad`);
`edge_hadamard` runs the row-gather kernel (`csrc/gather_rows.cu`) with its
product on CUDA tensors, one launch forward and one for each gradient term,
and plain indexing on CPU tensors."""

from __future__ import annotations

import torch

from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops.rows import add_gathered_rows_


class _Sddmm(torch.autograd.Function):
    """K2 forward, K2's gradient kernel backward: `g[e] * y[dst[e]]` into row
    `src[e]` of dx and `g[e] * x[src[e]]` into row `dst[e]` of dy, or both
    into one gradient when `y` is None, as the reference's autodiff of the
    gathers gives."""

    @staticmethod
    def forward(ctx, src, dst, x, y):
        ctx.save_for_backward(src, dst, x, y)
        return hk.sddmm(src, dst, x, x if y is None else y)

    @staticmethod
    def backward(ctx, g):
        src, dst, x, y = ctx.saved_tensors
        dx, dy = hk.sddmm_grad(g.float().contiguous(), src, dst, x, y)
        return None, None, dx, dy


def sddmm_coo(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor | None = None) -> torch.Tensor:
    """Per-edge dot products: [E] of `x.dtype` from x [N, F] (and optionally
    y [N, F]), summed in f32 and rounded once, as the reference's einsum
    yields. With `y` None both gradients flow into `x`, written as one."""
    return _Sddmm.apply(src, dst, x, y).to(x.dtype)


class _EdgeHadamard(torch.autograd.Function):
    """`x[src] * x[dst]` as one fused gather forward; backward the row sums
    that autograd takes for it, `g * x[dst]` into rows `src` plus `g *
    x[src]` into rows `dst`, each product one fused gather. Saves `x` and
    the indices, not the two gathered operands. An index equal to `len(x)`
    reads a zero row, as in `gather.gather_rows`."""

    @staticmethod
    def forward(ctx, src, dst, x):
        ctx.save_for_backward(src, dst, x)
        return hk.gather_rows(x, src, x, dst)

    @staticmethod
    def backward(ctx, g):
        src, dst, x = ctx.saved_tensors
        g, n = g.contiguous(), x.shape[0]
        # a zero row more than x has, as `gather.gather_rows` takes it
        into_src = add_gathered_rows_(x.new_zeros((n + 1, x.shape[1])), src,
                                      hk.gather_rows(x, dst, g))
        into_dst = add_gathered_rows_(x.new_zeros((n + 1, x.shape[1])), dst,
                                      hk.gather_rows(x, src, g))
        return None, None, (into_src + into_dst)[:n]


def edge_hadamard(src: torch.Tensor, dst: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Per-edge elementwise product of endpoint features: [E, ...] from `x`
    [N, ...] float32 (trailing dims ride as one row) and int64 `src`,
    `dst` [E], bit for bit `x[src] * x[dst]` and its gradient."""
    flat = x.reshape(x.shape[0], -1)
    out = (_EdgeHadamard.apply(src, dst, flat.contiguous()) if x.is_cuda
           else hk.gather_rows(flat, src, flat, dst))
    return out.reshape((src.shape[0],) + tuple(x.shape[1:]))


def edge_sum(src: torch.Tensor, dst: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Per-edge sum of endpoint features: [E, F]."""
    return x[src] + x[dst]
