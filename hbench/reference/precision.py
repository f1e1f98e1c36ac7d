"""Arithmetic of the reference at a stated precision: "f32" as written, or
"tf32" (matmul operands rounded to TF32, sums in f32, as the tensor cores do
with TF32 on). The rounding is emulated in f32 tensors, so a run reads the
same on the CPU and on the card."""

from __future__ import annotations

import torch

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, as f32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """`a @ b` with both operands rounded to TF32, in the forward and in
    both gradient products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return (g @ round_tf32(b).transpose(-1, -2),
                round_tf32(a).transpose(-1, -2) @ g)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """`a @ b` (batched over leading dims) at `precision`."""
    if precision == "tf32":
        return _TF32Matmul.apply(a, b)
    return a @ b

