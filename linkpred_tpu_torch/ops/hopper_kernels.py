"""Wrappers of the hand-written Hopper kernels — the counterpart of
`linkpred_tpu/ops/pallas_kernels.py`.

Each kernel has a plain PyTorch version beside it. A wrapper takes that
version only for tensors that lie on the CPU (the tests); for CUDA tensors it
launches the kernel or raises, with no fallback. `LAUNCHES` counts the
kernel launches of each wrapper, so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from linkpred_tpu_torch.kernels import build

LAUNCHES = {"spmm_ell": 0}


def spmm_ell_reference(nbr: torch.Tensor, w: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: `out[i] = sum_d w[i, d] * x[nbr[i, d]]`, f32.

    A slot whose weight is 0 or whose index lies outside `[0, x.shape[0])`
    contributes nothing, as in the kernel."""
    nx, f = x.shape
    keep = (nbr >= 0) & (nbr < nx) & (w != 0)
    idx = torch.where(keep, nbr, 0).long()
    rows = x.index_select(0, idx.reshape(-1)).reshape(*nbr.shape, f)
    contrib = torch.where(keep[..., None], w[..., None] * rows, 0.0)
    return contrib.sum(dim=1, dtype=torch.float32)


@functools.cache
def _spmm_ell_lib() -> ctypes.CDLL:
    lib = build.library("spmm_ell")
    lib.spmm_ell_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p]
    lib.spmm_ell_f32.restype = ctypes.c_int
    lib.spmm_ell_error_string.argtypes = [ctypes.c_int]
    lib.spmm_ell_error_string.restype = ctypes.c_char_p
    return lib


def spmm_ell(nbr: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """K1, the ELL SpMM `out[i, :] = sum_d w[i, d] * x[nbr[i, d], :]`.

    `nbr` [M, D] int32, `w` [M, D] float32, `x` [NX, F] float32 with any row
    count -> [M, F] float32. CUDA tensors run `csrc/spmm_ell.cu` (built at
    first use); CPU tensors run `spmm_ell_reference`."""
    if x.device.type == "cpu" and nbr.device.type == "cpu" \
            and w.device.type == "cpu":
        return spmm_ell_reference(nbr, w, x)
    for name, t, dtype in (("nbr", nbr, torch.int32), ("w", w, torch.float32),
                           ("x", x, torch.float32)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"spmm_ell: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"spmm_ell: {name} is {t.dtype}, needs {dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"spmm_ell: {name} must be 2-D and contiguous, got shape "
                f"{tuple(t.shape)} strides {t.stride()}")
    if nbr.shape != w.shape:
        raise ValueError(f"spmm_ell: nbr {tuple(nbr.shape)} != w {tuple(w.shape)}")
    m, d = nbr.shape
    nx, f = x.shape
    if max(m, d, nx, f) >= 2**31:
        raise ValueError("spmm_ell: a dimension above the kernel's int32 range")
    out = torch.empty((m, f), dtype=torch.float32, device=x.device)
    if m == 0 or f == 0:
        return out
    lib = _spmm_ell_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.spmm_ell_f32(nbr.data_ptr(), w.data_ptr(), x.data_ptr(),
                              out.data_ptr(), m, d, nx, f, stream)
    if rc != 0:
        raise RuntimeError(
            f"spmm_ell launch failed: {lib.spmm_ell_error_string(rc).decode()}")
    LAUNCHES["spmm_ell"] += 1
    return out
