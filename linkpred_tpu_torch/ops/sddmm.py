"""Per-edge products of endpoint features — the counterpart of
`linkpred_tpu/ops/sddmm.py`. `sddmm_coo` runs kernel K2
(`csrc/sddmm.cu`) on CUDA tensors and its plain version on CPU tensors
(`hopper_kernels.sddmm`)."""

from __future__ import annotations

import torch

from linkpred_tpu_torch.ops import hopper_kernels as hk


def _scatter_rows(index: torch.Tensor, rows: torch.Tensor, n: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """out[index[e]] += rows[e], summed in f32 -> [n, F] of `dtype`."""
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, index.long(), rows).to(dtype)


class _Sddmm(torch.autograd.Function):
    """K2 forward; the backward is plain PyTorch, as the reference's is
    XLA's autodiff of the gathers: g[e]·y[dst[e]] into row src[e] of dx,
    g[e]·x[src[e]] into row dst[e] of dy."""

    @staticmethod
    def forward(ctx, src, dst, x, y):
        ctx.save_for_backward(src, dst, x, y)
        return hk.sddmm(src, dst, x, y)

    @staticmethod
    def backward(ctx, g):
        src, dst, x, y = ctx.saved_tensors
        g = g.float()[:, None]
        dx = dy = None
        if ctx.needs_input_grad[2]:
            dx = _scatter_rows(src, g * y.index_select(0, dst.long()).float(),
                               x.shape[0], x.dtype)
        if ctx.needs_input_grad[3]:
            dy = _scatter_rows(dst, g * x.index_select(0, src.long()).float(),
                               y.shape[0], y.dtype)
        return None, None, dx, dy


def sddmm_coo(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor | None = None) -> torch.Tensor:
    """Per-edge dot products: [E] of `x.dtype` from x [N, F] (and optionally
    y [N, F]), summed in f32 and rounded once, as the reference's einsum
    yields. With `y` None both gradients flow into `x`."""
    if y is None:
        y = x
    return _Sddmm.apply(src, dst, x, y).to(x.dtype)


def edge_hadamard(src: torch.Tensor, dst: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Per-edge elementwise product of endpoint features: [E, F]."""
    return x[src] * x[dst]


def edge_sum(src: torch.Tensor, dst: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Per-edge sum of endpoint features: [E, F]."""
    return x[src] + x[dst]
