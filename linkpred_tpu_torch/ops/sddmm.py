"""Per-edge products of endpoint features — the counterpart of
`linkpred_tpu/ops/sddmm.py`. Plain PyTorch gathers; the TPU kernel K2
(`sddmm_pallas`) is not on a ported path yet."""

from __future__ import annotations

import torch


def sddmm_coo(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor | None = None) -> torch.Tensor:
    """Per-edge dot products: [E] from x [N, F] (and optionally y [N, F])."""
    if y is None:
        y = x
    return (x[src] * y[dst]).sum(dim=1)


def edge_hadamard(src: torch.Tensor, dst: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Per-edge elementwise product of endpoint features: [E, F]."""
    return x[src] * x[dst]


def edge_sum(src: torch.Tensor, dst: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Per-edge sum of endpoint features: [E, F]."""
    return x[src] + x[dst]
