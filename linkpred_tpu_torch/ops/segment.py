"""Segment aggregation — the counterpart of `linkpred_tpu/ops/segment.py`.

Host side (numpy): `SegmentPlan` groups the slots of a static segment
structure into degree-bucketed position matrices, and `composed_operands`
substitutes gathered rows into them, exactly as the JAX package builds them.

Device side (torch): `segment_sum`, `segment_mean`, `segment_max`,
`degree_from_edges`; the planned bucket-sum as a `torch.autograd.Function`
whose backward is one gather; `segment_sum_ell`, whose forward is kernel K1
(`hopper_kernels.spmm_ell`); and the composed gather-sum of the 2-WL
aggregation, whose forward and transposed backward run kernel K3
(`hopper_kernels.spmm_bucketed`) or the plain bucket-sum.
The TPU gather-lowering workarounds of the reference (`take_rows`,
`take_rows_fat`, `gather_rows_planned`, the one-hot VMEM bound) are not
ported: the port always builds the ELL operands.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from linkpred_tpu_torch.ops.hopper_kernels import (launch_order, spmm_bucketed,
                                                  spmm_ell)
from linkpred_tpu_torch.ops.gather import gather_rows
from linkpred_tpu_torch.ops.rows import add_rows, with_zero_row


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Masked segment sum. `data` [E, ...], `segment_ids` [E] -> [S, ...].
    Ids >= num_segments (capacity padding) are dropped. A segment's terms
    are added in a fixed order (`rows.add_rows`)."""
    if mask is not None:
        data = data * mask.reshape((-1,) + (1,) * (data.dim() - 1)).to(
            data.dtype)
    ids = segment_ids.long().clamp(max=num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return add_rows(out, ids, data)[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: torch.Tensor | None = None,
                 eps: float = 1e-12) -> torch.Tensor:
    """Masked segment mean; an empty segment gives 0."""
    ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    cnt = segment_sum(ones, segment_ids, num_segments, mask)
    tot = segment_sum(data, segment_ids, num_segments, mask)
    return tot / cnt.clamp(min=eps).reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment max, `jax.ops.segment_max`'s contract: an empty segment
    holds the dtype's lowest value (-inf for floats); ids outside
    `[0, num_segments)` are dropped."""
    lowest = (float("-inf") if data.dtype.is_floating_point
              else torch.iinfo(data.dtype).min)
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    ids = torch.where(keep, ids, num_segments)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), lowest,
                     dtype=data.dtype, device=data.device)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, "amax")[:num_segments]


def degree_from_edges(dst: torch.Tensor, num_nodes: int,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """In-degree by destination, f32 [num_nodes]; masked edges do not
    count."""
    ones = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    return segment_sum(ones, dst, num_nodes, mask)


def gcn_norm_coefficients(src: torch.Tensor, dst: torch.Tensor,
                          num_nodes: int, mask: torch.Tensor | None = None,
                          plan: tuple | None = None,
                          add_self_loops: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric GCN normalisation `1/sqrt(d_u d_v)` per edge (PyG
    `gcn_norm`): degrees count incoming edge weight by `dst`, +1 for the
    self loop when `add_self_loops`. Returns (edge_coeff [E],
    self_loop_coeff [N], zeros without self loops); `plan` is an optional
    `SegmentPlan.operands` tuple for `dst`."""
    ones = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    if mask is not None:
        ones = ones * mask.float()
    if plan is not None:
        deg = segment_sum_planned(ones, *plan)
    else:
        deg = segment_sum(ones, dst, num_nodes)
    if add_self_loops:
        deg = deg + 1.0
    dinv = torch.rsqrt(deg.clamp(min=1e-12))
    coeff = dinv[src] * dinv[dst]
    if mask is not None:
        coeff = coeff * mask.to(coeff.dtype)
    return coeff, (dinv * dinv if add_self_loops
                   else torch.zeros_like(dinv))


# ---------------------------------------------------------------------------
# host-built plans for static segment structures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Host-built plan for a static segment structure (the JAX package's
    `SegmentPlan`, built the same way so the two are array-equal).

    - `slot_buckets`: the slots of each segment, grouped into
      degree-bucketed `[m_b, w_b]` position matrices (power-of-two widths,
      pads = `num_slots`);
    - `inv_perm`: segment -> row of the concatenated buckets (count-0
      segments -> one past the last row, a zero row);
    - `dst_clipped`: segment id per slot, ids >= num_segments -> sentinel.
    """

    num_segments: int
    num_slots: int
    dst_clipped: np.ndarray  # [S] int32
    inv_perm: np.ndarray  # [num_segments] int32
    slot_buckets: tuple  # of int32 [m_b, w_b]

    @staticmethod
    def build(segment_ids: np.ndarray, num_segments: int) -> "SegmentPlan":
        ids = np.asarray(segment_ids, dtype=np.int64).reshape(-1)
        s = ids.shape[0]
        valid = (ids >= 0) & (ids < num_segments)
        counts = np.bincount(ids[valid], minlength=num_segments)
        order = np.argsort(ids[valid], kind="stable")
        slot_pos = np.nonzero(valid)[0][order].astype(np.int32)
        starts = np.concatenate([[0], np.cumsum(counts)])

        max_c = int(counts.max()) if num_segments else 0
        widths = []
        w = 4  # the narrowest bucket, as in the reference
        while True:
            widths.append(min(w, max(max_c, 1)))
            if w >= max_c:
                break
            w *= 2
        inv_perm = np.full(num_segments, -1, dtype=np.int64)
        slot_buckets = []
        offset = 0
        prev = 0
        for wd in widths:
            segs = np.nonzero((counts > prev) & (counts <= wd))[0]
            prev = wd
            if len(segs) == 0:
                continue
            pos = starts[segs][:, None] + np.arange(wd)[None, :]
            ok = np.arange(wd)[None, :] < counts[segs][:, None]
            mat = np.where(
                ok, slot_pos[np.minimum(pos, len(slot_pos) - 1)], np.int32(s),
            ).astype(np.int32)
            inv_perm[segs] = offset + np.arange(len(segs))
            offset += len(segs)
            slot_buckets.append(mat)
        inv_perm[inv_perm < 0] = offset
        return SegmentPlan(
            num_segments=num_segments,
            num_slots=s,
            dst_clipped=np.minimum(ids, num_segments).astype(np.int32),
            inv_perm=inv_perm.astype(np.int32),
            slot_buckets=tuple(slot_buckets),
        )

    def operands(self, device) -> tuple:
        """`(dst, inv_perm, slot_buckets)` as int64 tensors on `device`, for
        `segment_sum_planned` and `segment_sum_ell`."""
        return (
            torch.as_tensor(self.dst_clipped, dtype=torch.long, device=device),
            torch.as_tensor(self.inv_perm, dtype=torch.long, device=device),
            tuple(torch.as_tensor(b, dtype=torch.long, device=device)
                  for b in self.slot_buckets),
        )

    def ell_matrix(self) -> np.ndarray:
        """Host `[num_segments, W]` int32 slot matrix: row r lists the slot
        positions of segment r, pads = `num_slots`; W is the largest count.
        Equal to the first array of the reference's `ell_operands`."""
        W = max((b.shape[1] for b in self.slot_buckets), default=1)
        rows = [np.pad(b, ((0, 0), (0, W - b.shape[1])),
                       constant_values=self.num_slots)
                for b in self.slot_buckets]
        rows.append(np.full((1, W), self.num_slots, dtype=np.int32))
        return np.concatenate(rows, axis=0)[self.inv_perm]

    def ell_operands(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """K1's operands for `segment_sum_ell`: the slot matrix (int32) and
        its weights (float32, 1 on valid slots, 0 on pads), contiguous on
        `device`."""
        mat = self.ell_matrix()
        return (torch.as_tensor(mat, dtype=torch.int32, device=device),
                torch.as_tensor(mat < self.num_slots, dtype=torch.float32,
                                device=device))


class ComposedOps(NamedTuple):
    """One direction of a composed gather-sum on the device, in two layouts
    of the same buckets: `(inv_perm, buckets)` as int64 tensors for the
    plain bucket-sum, and `k3`, the arguments of `spmm_bucketed` after `x`:
    `(inv_perm [R] int32, bucket_shapes, nbr [S] int32, weight [S] float32,
    order [R] int32)` with the buckets' slots flattened in order, weights 1,
    the pads' sentinel left as it is (K3 drops an index outside `x`'s rows)
    and the widest-first launch order."""

    inv_perm: torch.Tensor
    buckets: tuple
    k3: tuple


def composed_operands(plan: SegmentPlan, values: np.ndarray, sentinel: int,
                      device) -> ComposedOps:
    """The operands of `gather_sum_composed`: the plan's slot buckets with
    `values[slot]` substituted (pads -> `sentinel`, the caller's zero row),
    on `device` in both layouts of `ComposedOps`."""
    values_ext = np.append(np.asarray(values, np.int64), sentinel).astype(
        np.int32)
    mats = [values_ext[b] for b in plan.slot_buckets]
    flat = np.concatenate([b.reshape(-1) for b in mats]
                          or [np.zeros(0, np.int32)])
    return ComposedOps(
        inv_perm=torch.as_tensor(plan.inv_perm, dtype=torch.long,
                                 device=device),
        buckets=tuple(torch.as_tensor(b, dtype=torch.long, device=device)
                      for b in mats),
        k3=(torch.as_tensor(plan.inv_perm, dtype=torch.int32, device=device),
            tuple((int(b.shape[0]), int(b.shape[1])) for b in mats),
            torch.as_tensor(flat, dtype=torch.int32, device=device),
            torch.ones(flat.shape, dtype=torch.float32, device=device),
            torch.as_tensor(launch_order(plan.inv_perm), device=device)),
    )


# ---------------------------------------------------------------------------
# device aggregations
# ---------------------------------------------------------------------------


def _bucket_sum(x: torch.Tensor, inv_perm: torch.Tensor,
                buckets: tuple) -> torch.Tensor:
    """out[r] = sum over bucket row inv_perm[r] of ext[idx]; ext = x plus a
    zero row at index len(x). `x` is [N, ...]; trailing dims are flattened."""
    tail = x.shape[1:]
    ext = with_zero_row(x.reshape(x.shape[0], -1))
    f = ext.shape[1]
    parts = [ext.index_select(0, b.reshape(-1)).reshape(*b.shape, f).sum(1)
             for b in buckets]
    parts.append(ext.new_zeros((1, f)))
    out = torch.cat(parts, dim=0).index_select(0, inv_perm)
    return out.reshape((out.shape[0],) + tuple(tail))


def _gather_dst(g: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The slot-partition transpose of a segment sum: slot s gets g[dst[s]]
    (0 for sentinel slots, `dst[s] == len(g)`: the row gather's zero
    row)."""
    return gather_rows(g, dst)


class _SegmentSumPlanned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, dst, inv_perm, slot_buckets):
        ctx.save_for_backward(dst)
        return _bucket_sum(msgs, inv_perm, slot_buckets)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return _gather_dst(g, dst), None, None, None


def segment_sum_planned(msgs: torch.Tensor, dst: torch.Tensor,
                        inv_perm: torch.Tensor,
                        slot_buckets: tuple) -> torch.Tensor:
    """Scatter-free segment sum over a `SegmentPlan`: `msgs` [S, ...] ->
    [num_segments, ...] (the length of `inv_perm`); the backward is the
    gather `g[dst]`."""
    return _SegmentSumPlanned.apply(msgs, dst, inv_perm, slot_buckets)


def _k3_sum(x: torch.Tensor, ops: ComposedOps) -> torch.Tensor:
    """The composed gather-sum of `x` [N, ...] on K3, over the flattened
    `[N, F]` rows."""
    out = spmm_bucketed(x.reshape(x.shape[0], -1).contiguous(), *ops.k3)
    return out.reshape((out.shape[0],) + tuple(x.shape[1:]))


def _composed_sum(x: torch.Tensor, ops: ComposedOps,
                  kernel: bool) -> torch.Tensor:
    """K3 when `kernel` is set (its plain version for CPU tensors), else
    the plain bucket-sum."""
    if kernel:
        return _k3_sum(x, ops)
    return _bucket_sum(x, ops.inv_perm, ops.buckets)


class _GatherSumComposed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_ops, bwd_ops, kernel):
        ctx.bwd_ops, ctx.kernel, ctx.n_rows = bwd_ops, kernel, x.shape[0]
        return _composed_sum(x, fwd_ops, kernel)

    @staticmethod
    def backward(ctx, g):
        dx = _composed_sum(g, ctx.bwd_ops, ctx.kernel)
        if dx.shape[0] != ctx.n_rows:
            raise ValueError(
                f"transpose structure covers {dx.shape[0]} rows, x has "
                f"{ctx.n_rows}")
        return dx, None, None, None


def gather_sum_composed(x: torch.Tensor, fwd_ops: ComposedOps,
                        bwd_ops: ComposedOps,
                        kernel: bool = False) -> torch.Tensor:
    """out[r] = sum over segment r's slots of x[idx_slot], with slot -> row
    indices composed on the host (`composed_operands`); index len(x) is an
    implicit zero row. `bwd_ops` is the transpose structure, so the backward
    is one gather-sum too. Trailing dims of `x` are flattened, so
    `[R, T, 2C]` rides one call.

    With `kernel`, forward and backward run K3 (`spmm_bucketed`) on the
    `ComposedOps.k3` layouts: the kernel for a CUDA tensor, with no
    fallback, its plain version for a CPU tensor. Otherwise both are the
    plain bucket-sum."""
    return _GatherSumComposed.apply(x, fwd_ops, bwd_ops, kernel)


class _SegmentSumEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, dst, slots, weight):
        ctx.save_for_backward(dst)
        out = spmm_ell(slots, weight,
                       msgs.reshape(msgs.shape[0], -1).contiguous())
        return out.reshape((out.shape[0],) + tuple(msgs.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return _gather_dst(g, dst), None, None, None


def segment_sum_ell(num_segments: int, msgs: torch.Tensor, dst: torch.Tensor,
                    slots: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Segment sum on kernel K1 — the counterpart of the reference's
    `segment_sum_onehot`: out[r] = sum_w weight[r, w] * msgs[slots[r, w]].

    `(slots, weight)` come from `SegmentPlan.ell_operands`, `dst` from
    `SegmentPlan.operands` (used only by the backward gather). `msgs` is
    [S, ...] float32, its trailing dims flattened for the kernel (the
    trial-major `[S, T, C]` is one `[S, T*C]` call); the slot sentinel `S`
    lies outside `msgs`' rows, and K1 drops such a slot."""
    if slots.shape[0] != num_segments:
        raise ValueError(
            f"ELL operands have {slots.shape[0]} rows, expected {num_segments}")
    return _SegmentSumEll.apply(msgs, dst, slots, weight)
