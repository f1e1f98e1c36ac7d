"""Per-edge products of endpoint features — the counterpart of
`linkpred_tpu/ops/sddmm.py`. `sddmm_coo` runs kernel K2 (`csrc/sddmm.cu`)
forward and its gradient kernel backward on CUDA tensors, and their plain
versions on CPU tensors (`hopper_kernels.sddmm`, `sddmm_grad`)."""

from __future__ import annotations

import torch

from linkpred_tpu_torch.ops import hopper_kernels as hk


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


def edge_hadamard(src: torch.Tensor, dst: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Per-edge elementwise product of endpoint features: [E, F]."""
    return x[src] * x[dst]


def edge_sum(src: torch.Tensor, dst: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Per-edge sum of endpoint features: [E, F]."""
    return x[src] + x[dst]
