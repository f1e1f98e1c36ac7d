"""Wrappers of the hand-written Hopper kernels — the counterpart of
`linkpred_tpu/ops/pallas_kernels.py`.

Each kernel has a plain PyTorch version beside it. A wrapper takes that
version only for tensors that lie on the CPU (the tests); for CUDA tensors it
launches the kernel or raises, with no fallback. `LAUNCHES` counts the
kernel launches of each wrapper, so a run can show that it went through the
kernel; `LAUNCHES_BY_WIDTH` counts the same launches by feature width. Both
count the host's launches: a launch recorded into a CUDA graph counts once,
at the capture, and the graph's replays add nothing (`models/twowl.
EPOCH_COUNTS` counts the single-trial loop's replays).

    K1 spmm_ell       csrc/spmm_ell.cu       ELL SpMM, f32
    K3 spmm_bucketed  csrc/spmm_bucketed.cu  bucketed ELL SpMM, f32 or bf16
    K2 sddmm          csrc/sddmm.cu          per-edge dot products -> f32
       sddmm_grad     csrc/sddmm.cu          their gradient, f32 or bf16
       gather_rows    csrc/gather_rows.cu    row gather, times a second
                                             operand's rows if given, f32
                                             or bf16 (no TPU kernel's port)

`spmm_ell_auto` and `sddmm_auto` are the reference's dispatch entries: thin
calls of K1 and K2 that build the kernels' operands.

K1, K3 and K2 choose a kernel by the shape and alignment of `x` (and K1 by
the slot count D and the row count M too) inside their launch functions:

    K1  split      rows of whole 16-byte groups when D > 32 and the rows are
                   few (fb-pages-food's [620, 114]): a block per (row, tile),
                   G lanes a slot, a warp per chunk of a row's slots, so a
                   long row's reads go out in one round; the warps' sums meet
                   in shared memory
        packed     rows of 1-32 whole 16-byte groups when D <= 32, or at most
                   4 groups, or more rows than the card holds warps and at
                   most 16 groups: a warp per row, G lanes a slot, 32 / G
                   slots gathered at once
        wide       other rows of whole 16-byte groups, 64 bytes or more: a
                   block per (row, 128-column tile), its warps sharing the
                   slots
        warp/row   any other shape
    K3  slot       rows under 16 bytes (F <= 3 f32, <= 7 bf16): a group of
                   lanes per row, one lane per slot, a shuffle tree per row
        packed     rows of 1-16 whole 16-byte groups (16-256 bytes: F = 4-64
                   f32, 8-128 bf16): G lanes a slot, G the row's groups
                   rounded up to a power of two, and up to 32 / G rows a
                   warp, as many as the output rows fill twice over the
                   warps the card holds at once
        wide       other rows of whole 16-byte groups: a warp per (row,
                   512-byte tile)
        warp/row   any other shape, lanes across F
    K2  packed     rows of whole 16-byte groups: G lanes an edge (16 at F = 128
                   bf16), 32 / G edges a round, two rounds a warp, the warp's
                   indices read once
        warp/edge  any other shape
        gradient   the incidences sorted by receiving row
                   (`incidence_order`) in windows of 16: a group of G lanes
                   a window sums each row's piece in sorted order and writes
                   the rows whose runs it holds; a second pass adds the
                   pieces of runs that span windows, in window order

`gather_rows` cuts its output into chunks of 16 bytes, or 4, or one
element, the widest that the row's bytes and the base addresses allow;
consecutive threads take consecutive chunks, many rows a block.

Every path sums in a fixed order, so two launches on the same inputs agree
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from linkpred_tpu_torch.kernels import build
from linkpred_tpu_torch.ops.rows import add_rows_, with_zero_row

# host launches by wrapper: a CUDA graph's kernels count at its capture only
LAUNCHES = {"spmm_ell": 0, "spmm_bucketed": 0, "sddmm": 0, "sddmm_grad": 0,
            "gather_rows": 0}
# the same launches by kernel and feature width, under keys "<kernel> F=<f>"
LAUNCHES_BY_WIDTH: dict[str, int] = {}

# dtype codes of the kernels templated on the feature type
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FEATURE_DTYPES = tuple(_DTYPE_CODES)
MAX_BUCKETS = 64  # kMaxBuckets of csrc/spmm_bucketed.cu
GRAD_WINDOW = 16  # kGradWindow of csrc/sddmm.cu
_INT32_MAX = 2**31 - 1


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(kernel: str, device: torch.device, operands) -> None:
    """Raise unless each `(name, tensor, dtypes, ndim)` is a contiguous
    CUDA tensor on `device` with one of `dtypes` and `ndim` dimensions."""
    for name, t, dtypes, ndim in operands:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{kernel}: {name} on {t.device}, x on {device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, needs "
                            f"{' or '.join(map(str, dtypes))}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be {ndim}-D and contiguous, got shape "
                f"{tuple(t.shape)} strides {t.stride()}")


def _check_int32_range(kernel: str, *sizes: int) -> None:
    if max(sizes, default=0) > _INT32_MAX:
        raise ValueError(f"{kernel}: a dimension above the kernel's int32 range")


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# kernel -> (C entry point, its argument types: pointers and the stream as
# void*), in csrc/<kernel>.cu unless _SOURCES names another source
_ENTRY_POINTS = {
    "spmm_ell": ("spmm_ell_f32", [_P] * 4 + [_I64] * 4 + [_P]),
    "spmm_bucketed": ("spmm_bucketed", [_I32] + [_P] * 6 + [_I64] * 4
                      + [_P, _P]),
    "sddmm": ("sddmm", [_I32] + [_P] * 5 + [_I64] * 4 + [_P]),
    "sddmm_grad": ("sddmm_grad", [_I32] + [_P] * 11 + [_I64] * 4
                   + [_I32, _P]),
    "gather_rows": ("gather_rows", [_I32] + [_P] * 5 + [_I64] * 4 + [_P]),
    "empty_launch": ("empty_launch", [_P]),
}
_SOURCES = {"sddmm_grad": "sddmm"}


@functools.cache
def _entry(name: str):
    """Kernel `name`'s source built and loaded: its launch function and the
    source's `<source>_error_string`, with their types declared."""
    source = _SOURCES.get(name, name)
    lib = build.library(source)
    symbol, argtypes = _ENTRY_POINTS[name]
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = getattr(lib, f"{source}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, err


def _launch(name: str, f: int, *args) -> None:
    """Launch kernel `name` with `args` (the stream last) and count the
    launch, also under its feature width `f`; raise with CUDA's message when
    it was refused."""
    fn, err = _entry(name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()}")
    LAUNCHES[name] += 1
    key = f"{name} F={f}"
    LAUNCHES_BY_WIDTH[key] = LAUNCHES_BY_WIDTH.get(key, 0) + 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def empty_launch(device: torch.device) -> None:
    """Launch `csrc/empty_launch.cu`, a kernel that does nothing, on
    `device`: what a measurement times as the floor under any kernel. It is
    no kernel of a path and is not counted in `LAUNCHES`."""
    fn, err = _entry("empty_launch")
    with torch.cuda.device(device):
        rc = fn(_stream(device))
    if rc != 0:
        raise RuntimeError(f"empty_launch failed: {err(rc).decode()}")


# ---------------------------------------------------------------------------
# K1: ELL SpMM
# ---------------------------------------------------------------------------


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


def spmm_ell(nbr: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """K1, the ELL SpMM `out[i, :] = sum_d w[i, d] * x[nbr[i, d], :]`.

    `nbr` [M, D] int32, `w` [M, D] float32, `x` [NX, F] float32 with any row
    count -> [M, F] float32. CUDA tensors run `csrc/spmm_ell.cu` (built at
    first use); CPU tensors run `spmm_ell_reference`."""
    if _on_cpu(nbr, w, x):
        return spmm_ell_reference(nbr, w, x)
    _check_cuda("spmm_ell", x.device, (
        ("nbr", nbr, (torch.int32,), 2), ("w", w, (torch.float32,), 2),
        ("x", x, (torch.float32,), 2)))
    if nbr.shape != w.shape:
        raise ValueError(f"spmm_ell: nbr {tuple(nbr.shape)} != w {tuple(w.shape)}")
    m, d = nbr.shape
    nx, f = x.shape
    _check_int32_range("spmm_ell", m, d, nx, f)
    out = torch.empty((m, f), dtype=torch.float32, device=x.device)
    if m == 0 or f == 0:
        return out
    with torch.cuda.device(x.device):
        _launch("spmm_ell", f, nbr.data_ptr(), w.data_ptr(), x.data_ptr(),
                out.data_ptr(), m, d, nx, f, _stream(x.device))
    return out


def spmm_ell_auto(nbr: torch.Tensor, nbr_mask: torch.Tensor, x: torch.Tensor,
                  nbr_weight: torch.Tensor | None = None) -> torch.Tensor:
    """K1 on an ELL layout given as `nbr` [M, D], `nbr_mask` [M, D] bool and
    optional `nbr_weight` [M, D]: the slot weights are `mask * weight` in
    f32, `x` is taken in f32 -> [M, F] f32. The reference's dispatch entry
    of its Pallas kernel (`pallas_kernels.spmm_ell_auto`)."""
    w = nbr_mask.float()
    if nbr_weight is not None:
        w = w * nbr_weight.float()
    return spmm_ell(nbr.to(torch.int32).contiguous(), w.contiguous(),
                    x.float().contiguous())


# ---------------------------------------------------------------------------
# K3: bucketed ELL SpMM
# ---------------------------------------------------------------------------


def launch_order(inv_perm) -> np.ndarray:
    """The order in which K3 takes the output rows, from a host `inv_perm`
    [N]: by concat row from the last down, so the rows of the widest bucket
    start first and no long row is left for the end. int32 [N]."""
    return np.argsort(-np.asarray(inv_perm, dtype=np.int64),
                      kind="stable").astype(np.int32)


def spmm_bucketed_reference(x: torch.Tensor, inv_perm: torch.Tensor,
                            bucket_shapes: tuple, nbr: torch.Tensor,
                            w: torch.Tensor,
                            order: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K3, the reference's `spmm_bucketed`: per bucket of
    `(rows, width)` slots, `agg[r] = sum_d round(w[r, d]) * x[nbr[r, d]]`
    with the weight rounded to `x.dtype` and the sum in f32; then the
    aggregates, with one zero row appended, are gathered by `inv_perm`
    [N] and rounded to `x.dtype` once. A slot whose weight is 0 or whose
    index lies outside `[0, x.shape[0])` contributes nothing. `order`, the
    kernel's launch order, does not change the result and is ignored."""
    nx, f = x.shape
    keep = (nbr >= 0) & (nbr < nx) & (w != 0)
    idx = torch.where(keep, nbr, 0).long()
    wr = torch.where(keep, w, 0.0).to(x.dtype).float()
    parts, s0 = [], 0
    for rows, width in bucket_shapes:
        s1 = s0 + rows * width
        g = x.index_select(0, idx[s0:s1]).reshape(rows, width, f).float()
        # a dropped slot's row may hold NaN: select, do not multiply by 0
        g = torch.where(keep[s0:s1].reshape(rows, width, 1), g, 0.0)
        parts.append(torch.einsum("nd,ndf->nf",
                                  wr[s0:s1].reshape(rows, width), g))
        s0 = s1
    parts.append(torch.zeros((1, f), dtype=torch.float32, device=x.device))
    return torch.cat(parts).index_select(0, inv_perm.long()).to(x.dtype)


def spmm_bucketed(x: torch.Tensor, inv_perm: torch.Tensor,
                  bucket_shapes: tuple, nbr: torch.Tensor,
                  w: torch.Tensor,
                  order: torch.Tensor | None = None) -> torch.Tensor:
    """K3, the bucketed ELL SpMM with its output assembly, in one launch.

    `x` [NX, F] float32 or bfloat16, `inv_perm` [N] int32 (each output
    row's row among the buckets' concatenated rows; their count means the
    zero row), `bucket_shapes` a host tuple of `(rows, width)`, `nbr` [S]
    int32 and `w` [S] float32 the buckets' slots concatenated in order ->
    [N, F] of `x.dtype`. `order` [N] int32, a permutation of the output rows
    (`launch_order`), is the order the kernel takes them in; without it they
    go in row order. The result does not depend on it. CUDA tensors run
    `csrc/spmm_bucketed.cu` (built at first use); CPU tensors run
    `spmm_bucketed_reference`."""
    if _on_cpu(x, inv_perm, nbr, w):
        return spmm_bucketed_reference(x, inv_perm, bucket_shapes, nbr, w)
    operands = [("x", x, _FEATURE_DTYPES, 2),
                ("inv_perm", inv_perm, (torch.int32,), 1),
                ("nbr", nbr, (torch.int32,), 1),
                ("w", w, (torch.float32,), 1)]
    if order is not None:
        operands.append(("order", order, (torch.int32,), 1))
        if order.shape != inv_perm.shape:
            raise ValueError(f"spmm_bucketed: order {tuple(order.shape)} != "
                             f"inv_perm {tuple(inv_perm.shape)}")
    _check_cuda("spmm_bucketed", x.device, operands)
    if len(bucket_shapes) > MAX_BUCKETS:
        raise ValueError(f"spmm_bucketed: {len(bucket_shapes)} buckets, the "
                         f"kernel takes at most {MAX_BUCKETS}")
    n_slots = sum(r * wd for r, wd in bucket_shapes)
    if nbr.shape[0] != n_slots or w.shape[0] != n_slots:
        raise ValueError(f"spmm_bucketed: buckets hold {n_slots} slots, nbr "
                         f"{nbr.shape[0]}, w {w.shape[0]}")
    n = inv_perm.shape[0]
    nx, f = x.shape
    _check_int32_range("spmm_bucketed", n, nx, f,
                       sum(r for r, _ in bucket_shapes),
                       *(wd for _, wd in bucket_shapes))
    out = torch.empty((n, f), dtype=x.dtype, device=x.device)
    if n == 0 or f == 0:
        return out
    shapes = (ctypes.c_int64 * (2 * len(bucket_shapes)))(
        *(v for shape in bucket_shapes for v in shape))
    with torch.cuda.device(x.device):
        _launch("spmm_bucketed", f, _DTYPE_CODES[x.dtype], x.data_ptr(),
                inv_perm.data_ptr(),
                None if order is None else order.data_ptr(), nbr.data_ptr(),
                w.data_ptr(), out.data_ptr(), n, nx, f, len(bucket_shapes),
                ctypes.addressof(shapes), _stream(x.device))
    return out


# ---------------------------------------------------------------------------
# K2: SDDMM
# ---------------------------------------------------------------------------


def sddmm_reference(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: `out[e] = sum_f x[src[e], f] * y[dst[e], f]`, summed
    in f32 -> [E] float32; 0 where an index lies outside its table."""
    keep = (src >= 0) & (src < x.shape[0]) & (dst >= 0) & (dst < y.shape[0])
    xs = x.index_select(0, torch.where(keep, src, 0).long()).float()
    yd = y.index_select(0, torch.where(keep, dst, 0).long()).float()
    return torch.where(keep, (xs * yd).sum(dim=1), 0.0)


def sddmm(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """K2, per-edge dot products of endpoint features.

    `src`, `dst` [E] int32, `x` [NX, F] and `y` [NY, F] both float32 or both
    bfloat16 -> [E] float32 (sums in f32), as the TPU kernel returns. CUDA
    tensors run `csrc/sddmm.cu` (built at first use); CPU tensors run
    `sddmm_reference`."""
    if _on_cpu(src, dst, x, y):
        return sddmm_reference(src, dst, x, y)
    _check_cuda("sddmm", x.device, (
        ("src", src, (torch.int32,), 1), ("dst", dst, (torch.int32,), 1),
        ("x", x, _FEATURE_DTYPES, 2), ("y", y, (x.dtype,), 2)))
    if src.shape != dst.shape or x.shape[1] != y.shape[1]:
        raise ValueError(f"sddmm: src {tuple(src.shape)}, dst "
                         f"{tuple(dst.shape)}, x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}")
    e = src.shape[0]
    (nx, f), ny = x.shape, y.shape[0]
    _check_int32_range("sddmm", e, nx, ny, f)
    out = torch.empty((e,), dtype=torch.float32, device=x.device)
    if e == 0:
        return out
    with torch.cuda.device(x.device):
        _launch("sddmm", f, _DTYPE_CODES[x.dtype], src.data_ptr(),
                dst.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
                e, nx, ny, f, _stream(x.device))
    return out


def sddmm_auto(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor | None = None) -> torch.Tensor:
    """K2 with `y = x` when no `y` is given and int32 contiguous indices:
    [E] f32. The reference's dispatch entry of its Pallas kernel
    (`pallas_kernels.sddmm_auto`)."""
    y = x if y is None else y
    return sddmm(src.to(torch.int32).contiguous(),
                 dst.to(torch.int32).contiguous(), x.contiguous(),
                 y.contiguous())


def incidence_order(src: torch.Tensor, dst: torch.Tensor,
                    two_tables: bool = False) -> torch.Tensor:
    """The order in which K2's gradient takes the pairs' 2E incidences
    (`i < E`: row `src[i]` receives `g[i] * y[dst[i]]`; `E + e`: row
    `dst[e]` receives `g[e] * x[src[e]]`), from `src`, `dst` [..., E]:
    sorted by receiving row, stably, so a row's incidences keep their order.
    With `two_tables` the first E positions are the src incidences sorted by
    src and the next E the dst ones sorted by dst (dx and dy apart). int32
    [..., 2E]; a leading dimension sorts each batch of pairs on its own, so
    the orders of many steps build at once."""
    if two_tables:
        e = src.shape[-1]
        order = torch.cat([torch.argsort(src, dim=-1, stable=True),
                           e + torch.argsort(dst, dim=-1, stable=True)], -1)
    else:
        order = torch.argsort(torch.cat([src, dst], -1), dim=-1, stable=True)
    return order.to(torch.int32)


def sddmm_grad_reference(g: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor | None = None):
    """Plain PyTorch gradient of K2 for the cotangent `g` [E]: `(dx, dy)`
    with `dx[n] = sum_{e: src[e] = n} g[e] * y[dst[e]]` and `dy[n] = sum_{e:
    dst[e] = n} g[e] * x[src[e]]`; with `y` None (one table) `(dx + dy,
    None)`. A pair with an index outside its table contributes nothing, as
    it scored 0.

    Each product of an f32 cotangent and an f32 or bf16 row is exact in
    float64; each row's products are summed in float64, in a fixed order
    (`rows.add_rows_`), and rounded to the tables' type (bf16 through f32).
    Hundreds of terms in f64 keep the sum's error some 1e-13 of its size,
    so the f32 result is the exact sum rounded to within half an ulp (bar
    a tie), and the same from run to run."""
    table = x if y is None else y
    keep = ((src >= 0) & (src < x.shape[0]) & (dst >= 0)
            & (dst < table.shape[0]))
    s = torch.where(keep, src, 0).long()
    d = torch.where(keep, dst, 0).long()
    gk = g.double()[:, None]

    def term(index, rows):
        # a dropped pair's row may hold NaN: select, do not multiply by 0
        return index, torch.where(keep[:, None], gk * rows.double(), 0.0)

    into_x = term(s, table.index_select(0, d))
    into_y = term(d, x.index_select(0, s))
    f = x.shape[1]

    def zeros(rows):
        return torch.zeros((rows, f), dtype=torch.float64, device=x.device)

    if y is None:
        out = add_rows_(zeros(x.shape[0]), torch.cat([into_x[0], into_y[0]]),
                        torch.cat([into_x[1], into_y[1]]))
        return out.float().to(x.dtype), None
    return (add_rows_(zeros(x.shape[0]), *into_x).float().to(x.dtype),
            add_rows_(zeros(y.shape[0]), *into_y).float().to(y.dtype))


def sddmm_grad(g: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               x: torch.Tensor, y: torch.Tensor | None = None,
               order: torch.Tensor | None = None):
    """K2's gradient for the cotangent `g` [E] float32 of `sddmm(src, dst,
    x, y)`: `(dx, dy)` of the tables' type, or `(dx + dy, None)` written as
    one table when `y` is None (`x` scored against itself). `order` [2E]
    int32 is `incidence_order(src, dst, y is not None)`, built here when
    not given. CUDA tensors zero the outputs and run the kernel in
    `csrc/sddmm.cu` (built at first use); CPU tensors run
    `sddmm_grad_reference`."""
    table = x if y is None else y
    if _on_cpu(g, src, dst, x, table):
        return sddmm_grad_reference(g, src, dst, x, y)
    two = y is not None
    if order is None:
        order = incidence_order(src, dst, two)
    _check_cuda("sddmm_grad", x.device, (
        ("g", g, (torch.float32,), 1), ("src", src, (torch.int32,), 1),
        ("dst", dst, (torch.int32,), 1), ("order", order, (torch.int32,), 1),
        ("x", x, _FEATURE_DTYPES, 2), ("y", table, (x.dtype,), 2)))
    e = src.shape[0]
    if (dst.shape != src.shape or g.shape != src.shape
            or order.shape != (2 * e,) or table.shape[1] != x.shape[1]):
        raise ValueError(f"sddmm_grad: g {tuple(g.shape)}, src "
                         f"{tuple(src.shape)}, dst {tuple(dst.shape)}, order "
                         f"{tuple(order.shape)}, x {tuple(x.shape)}, y "
                         f"{tuple(table.shape)}")
    (nx, f), ny = x.shape, table.shape[0]
    _check_int32_range("sddmm_grad", 2 * e, nx, ny, f)
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(table) if two else None
    if e == 0 or f == 0:
        return dx, dy
    # the two passes' scratch: a window's piece sums, state and run row
    windows = -(-2 * e // GRAD_WINDOW)
    part = torch.empty((windows, 2, f), dtype=torch.float32, device=x.device)
    state = torch.empty(windows, dtype=torch.int32, device=x.device)
    run_row = torch.empty(windows, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("sddmm_grad", f, _DTYPE_CODES[x.dtype], order.data_ptr(),
                src.data_ptr(), dst.data_ptr(), g.data_ptr(), x.data_ptr(),
                table.data_ptr(), dx.data_ptr(),
                None if dy is None else dy.data_ptr(), part.data_ptr(),
                state.data_ptr(), run_row.data_ptr(), e, nx, ny, f, int(two),
                _stream(x.device))
    return dx, dy


# ---------------------------------------------------------------------------
# row gather (no TPU kernel: the JAX package leaves its gathers to XLA)
# ---------------------------------------------------------------------------


def _take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """`t[i]` along dim 0, where `i == len(t)` reads a zero row and any
    other index outside `[0, len(t))` raises IndexError."""
    n = t.shape[0]
    if i.numel():
        lo, hi = int(i.min()), int(i.max())
        if lo < 0 or hi > n:
            raise IndexError(f"gather_rows: index {lo if lo < 0 else hi} "
                             f"outside a table of {n} rows")
        if hi == n:
            t = with_zero_row(t)
    return t[i]


def gather_rows_reference(x: torch.Tensor, idx: torch.Tensor,
                          y: torch.Tensor | None = None,
                          j: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch `gather_rows`: `x[idx]`, times `y[j]` (or `y`) when `y`
    is given, in the operands' type. An index equal to its table's row
    count reads a zero row; any other index outside `[0, rows)` raises
    IndexError. Differentiable: autograd takes `x[idx]`'s own gradient."""
    out = _take(x, idx)
    if y is not None:
        out = out * (y if j is None else _take(y, j))
    return out


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                y: torch.Tensor | None = None,
                j: torch.Tensor | None = None) -> torch.Tensor:
    """The row gather `out[r] = x[idx[r]]`, or with `y` the product
    `out[r] = x[idx[r]] * y[j[r]]` (`y[r]` without `j`), in one launch.

    `x` [NX, F] and `y` [NY, F] both float32 or both bfloat16, `idx` and
    `j` [R] int64 -> [R, F] of `x.dtype`, bit for bit the plain result. An
    index equal to its table's row count reads a zero row; on the card any
    other index outside the table stops the kernel, which the next
    synchronise reports. CUDA tensors run `csrc/gather_rows.cu` (built at
    first use); CPU tensors run `gather_rows_reference`."""
    if _on_cpu(*(t for t in (x, idx, y, j) if t is not None)):
        return gather_rows_reference(x, idx, y, j)
    operands = [("x", x, _FEATURE_DTYPES, 2), ("idx", idx, (torch.int64,), 1)]
    if y is not None:
        operands.append(("y", y, (x.dtype,), 2))
    if j is not None:
        operands.append(("j", j, (torch.int64,), 1))
    _check_cuda("gather_rows", x.device, operands)
    r, (nx, f) = idx.shape[0], x.shape
    ny = r if y is None else y.shape[0]
    if (j is not None and (y is None or j.shape[0] != r)) or (
            y is not None and (y.shape[1] != f or (j is None and ny != r))):
        raise ValueError(f"gather_rows: x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}, y "
                         f"{None if y is None else tuple(y.shape)}, j "
                         f"{None if j is None else tuple(j.shape)}")
    # the kernel counts the output's chunks, at most one an element
    _check_int32_range("gather_rows", r * f)
    out = torch.empty((r, f), dtype=x.dtype, device=x.device)
    if r == 0 or f == 0:
        return out
    with torch.cuda.device(x.device):
        _launch("gather_rows", f, _DTYPE_CODES[x.dtype], x.data_ptr(),
                idx.data_ptr(), None if y is None else y.data_ptr(),
                None if j is None else j.data_ptr(), out.data_ptr(), r, nx,
                ny, f, _stream(x.device))
    return out
