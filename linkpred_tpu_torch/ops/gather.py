"""The row gather `x[index]` along dim 0, on the card's row-gather kernel
(`hopper_kernels.gather_rows`, `csrc/gather_rows.cu`) with the row sum of
`ops/rows` as its gradient. CPU tensors take plain indexing and autograd's
own gradient, bit for bit `x[index]`."""

from __future__ import annotations

import torch

from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops.rows import add_gathered_rows_


class _GatherRows(torch.autograd.Function):
    """`hopper_kernels.gather_rows` forward; backward the row sum that
    autograd takes for `x[index]`, into a zero row more than `x` has (an
    index equal to `len(x)` read a zero row and receives nothing)."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.rows = x.shape[0]
        return hk.gather_rows(x, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        dx = g.new_zeros((ctx.rows + 1,) + tuple(g.shape[1:]))
        return add_gathered_rows_(dx, index, g.contiguous())[:ctx.rows], None


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """`x[index]` along dim 0 for `x` [N, ...] float32 or bfloat16 and
    `index` [E] int64 -> [E, ...], bit for bit, on the row-gather kernel for
    CUDA tensors (trailing dims ride as one row). `index == N` reads a zero
    row; any other index outside `[0, N)` raises."""
    flat = x.reshape(x.shape[0], -1)
    out = (_GatherRows.apply(flat.contiguous(), index) if x.is_cuda
           else hk.gather_rows(flat, index))
    return out.reshape((index.shape[0],) + tuple(x.shape[1:]))
