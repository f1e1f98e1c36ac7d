"""The yardstick's arithmetic: bytes and operations of the port's sparse
kernels, the model FLOPs of a step, the card's peaks, and the shares of a
roofline or a peak that the per-layer readers report.

Bytes and operations are those of the function, counted from the
aggregation's own inputs (an edge list), never from the port's layout: each
row of `x` that a live edge names is read once, each live edge costs one
index and one weight, each output row is written once, and a multiply-add is
2 operations. So a later change to a layout or a kernel leaves the yardstick
where it is. Derived from `chip_smoke.spmm_ell_work`, `spmm_bucketed_work`
and `bound`, corrected in two places: K3's
`inv_perm` (the port's layout) is not counted, and bf16 work is held to the
bf16 peak, not to the f32 rate.

numpy only; nothing here needs a card.
"""

from __future__ import annotations

import numpy as np

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without sparsity, at
# its 700 W limit: HBM3 bytes/s and FLOP/s by the dtype of the work. The
# port turns TF32 off (`utils.device.cuda_device`), so f32 work is held to
# the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"f32": 67e12, "bf16": 989e12}
ITEM_BYTES = {"f32": 4, "bf16": 2}
INDEX_BYTES = 4  # int32 index per edge
WEIGHT_BYTES = 4  # f32 weight per edge


def distinct(a) -> int:
    return int(np.unique(np.asarray(a)).size)


def aggregation_work(src_rows, n_out: int, width: int, dtype: str,
                     out_dtype: str | None = None) -> dict:
    """`out[dst_e] += w_e * x[src_e]` over the live edges whose source rows
    are `src_rows` [E], into `n_out` output rows of `width` columns: K1 and
    K3 (forward, transposed, or the degree pass at width 1)."""
    src_rows = np.asarray(src_rows)
    e = int(src_rows.size)
    out_dtype = out_dtype or dtype
    return {
        "bytes": (distinct(src_rows) * width * ITEM_BYTES[dtype]
                  + e * (INDEX_BYTES + WEIGHT_BYTES)
                  + n_out * width * ITEM_BYTES[out_dtype]),
        "flops": 2 * e * width,
        "dtype": dtype,
    }


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: bytes over its memory rate or
    operations over its peak for `dtype`, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype])


def roofline_share(ops: list, kernel: str) -> float | None:
    """Percent of its roofline that `kernel` reaches over the calls of one
    step: the bytes and operations of every call summed, and their measured
    times likewise (`ops` entries: kernel, bytes, flops, dtype, calls,
    seconds per call). None where the step makes no such call."""
    mine = [o for o in ops if o["kernel"] == kernel]
    if not mine:
        return None
    spent = sum(o["calls"] * o["seconds"] for o in mine)
    least = 0.0
    for dtype in {o["dtype"] for o in mine}:
        same = [o for o in mine if o["dtype"] == dtype]
        least += least_seconds(sum(o["calls"] * o["bytes"] for o in same),
                               sum(o["calls"] * o["flops"] for o in same),
                               dtype)
    return 100.0 * least / spent


def matmul_flops(m: int, k: int, n: int, batch: int = 1) -> int:
    return 2 * batch * m * k * n


def twowl_epoch_flops(num_nodes: int, num_msg: int, train_rows: int,
                      train_slots: int, val_rows: int, val_slots: int,
                      batch_pairs: int, val_pairs: int, channels_1wl: int,
                      channels_2wl: int, depth1: int, depth2: int,
                      trials: int) -> int:
    """Model FLOPs of one TwoWL epoch (one masked train step, forward and
    backward, and the val split's forward), counted once from the shapes:
    the GCN matmuls of both stacks, the 1-WL aggregation over the message
    edges, the paired 2-WL aggregation (two directions) over the ei2 slots,
    the edge Hadamard product and the pair head. A backward costs twice its
    forward (the input's and the weight's gradient)."""
    dims = [channels_1wl] * depth1 + [channels_2wl]

    def forward(rows, slots, pairs):
        f = 0
        for i in range(depth1):
            f += matmul_flops(num_nodes, dims[i], dims[i + 1])
            f += 2 * num_msg * dims[i + 1]
        f += rows * channels_2wl  # edge Hadamard product
        for _ in range(depth2):
            f += 2 * matmul_flops(rows, channels_2wl, channels_2wl)
            f += 2 * 2 * slots * channels_2wl
        f += pairs * channels_2wl + 2 * pairs * channels_2wl  # pair, head
        return f

    return trials * (3 * forward(train_rows, train_slots, batch_pairs)
                     + forward(val_rows, val_slots, val_pairs))

