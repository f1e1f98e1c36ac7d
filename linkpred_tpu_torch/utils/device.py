"""Device selection for the port: the card, or an error — never a silent CPU run."""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """The CUDA device every measured or user-facing run uses.

    Raises when no card is visible: a run that asked for the card does not
    fall back to the CPU. Also pins float32 matmuls and convolutions to full
    float32 (no TF32): the port is checked against the JAX package in f32,
    and TF32 keeps only about three decimal digits.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; linkpred_tpu_torch runs on the card "
            "(tests pass device='cpu' explicitly)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())
