"""Device selection for the port: the card, or an error — never a silent CPU run."""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """The CUDA device every measured or user-facing run uses.

    Raises when no card is visible: a run that asked for the card does not
    fall back to the CPU. Also pins float32 matmuls and convolutions to full
    float32 (no TF32): the port is checked against the JAX package in f32,
    and TF32 keeps only about three decimal digits. And asks cuDNN for
    deterministic algorithms, chosen without benchmarking: its weight
    gradient of a convolution (SEAL's `conv1d`) may otherwise sum in an
    order that changes from run to run.

    The port repeats bit for bit, as the JAX package does: one seed gives
    one result. Every float sum into rows that more than one term can
    reach is taken in a fixed order. The kernels write each row once; the
    plain code around them adds such rows through `ops.rows.add_rows(_)`
    (on the card `index_put_(..., accumulate=True)`, which sorts the
    indices stably and adds each row's terms in that order), never with
    `index_add_`, `scatter_add_` or `scatter_reduce`'s sum or mean, which
    add by atomics on the card in an order that changes from run to run
    (`tests/test_torch_determinism.py` holds the package to this). New
    port code follows the same rule.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; linkpred_tpu_torch runs on the card "
            "(tests pass device='cpu' explicitly)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda", torch.cuda.current_device())
