"""Collectives with gradients, and a probe of what a backend takes.

`torch.distributed`'s collectives carry no gradient. The sharded paths of
the port use the four below, each a `torch.autograd.Function`, under one
convention for the values they pass between ranks:

- a *row-sharded* value is one block of rows per rank (`rows_per_shard`
  rows each, the last block padded); its gradient on a rank is that
  block's gradient, whole;
- a *replicated* value is the same on every rank, and its gradient on a
  rank is whole at least on the rank's own block of rows: the functions
  that turn it back into row-sharded blocks read no other rows.

`all_reduce_sum` ends a rank-local partial sum whose consumers are
replicated (forward: the sum over the group; backward: the cotangent as it
is, since every rank computes the same downstream loss). `grad_all_reduce`
opens one (forward: the value as it is; backward: the sum of the ranks'
partial gradients) — Megatron's pair of conjugate operators, and what the
edge-sharded 2-WL aggregation of the TwoWL step runs between. `gather_rows`
makes row-sharded blocks replicated (forward: all-gather; backward: the
rank's own block of the cotangent).

`all_gather_blocks` and `all_to_all_blocks` move blocks with no gradient
(the distributed node2vec's int32 indices and walker frontier).

`probe` tries each collective the port uses on a group and tensors of a
device and says which it takes: gloo moves CUDA tensors through the host,
and not every build takes every collective that way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from linkpred_tpu_torch.ops.rows import add_rows_

# `all_gather_into_tensor` under the name that newer releases give it (the
# same call; the old name warns there)
all_gather_single = getattr(dist, "all_gather_single",
                            dist.all_gather_into_tensor)


def all_gather_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-shaped `x` stacked along the leading axis, in group
    rank order: [S * x.shape[0], ...]. No gradient. Any dtype the backend
    takes (`probe`): the distributed SGNS gathers its int32 index blocks
    with it, as the reference's `all_gather(..., tiled=True)`."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    all_gather_single(out, x.contiguous(), group=group)
    return out


def all_to_all_blocks(send: torch.Tensor, group) -> torch.Tensor:
    """`send` [S, ...]: block j goes to group rank j; returns [S, ...] whose
    block i came from group rank i (the reference's untiled `all_to_all`
    with split and concat on axis 0). No gradient."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    return recv


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, num_rows):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_blocks(x, group)[:num_rows]

    @staticmethod
    def backward(ctx, g):
        lo = dist.get_rank(ctx.group) * ctx.rows
        own = g[lo: lo + ctx.rows]
        if own.shape[0] < ctx.rows:  # the padded rows of the last block
            own = torch.cat([own, own.new_zeros(
                (ctx.rows - own.shape[0],) + tuple(own.shape[1:]))])
        return own.contiguous(), None, None


class _GatherById(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, group):
        lo = dist.get_rank(group) * x.shape[0]
        own = (ids >= lo) & (ids < lo + x.shape[0])
        local = torch.where(own, ids - lo, 0)
        ctx.save_for_backward(own, local)
        ctx.rows = x.shape[0]
        out = torch.where(own[:, None], x.index_select(0, local), 0)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        own, local = ctx.saved_tensors
        dx = g.new_zeros((ctx.rows, g.shape[1]))
        # the pairs name rows more than once: a fixed-order sum
        return add_rows_(dx, local[own], g[own]), None, None


def gather_by_id(x: torch.Tensor, ids: torch.Tensor, group) -> torch.Tensor:
    """Rows `ids` (global row ids, replicated) of the row-sharded blocks
    `x` [rows_per_shard, F]: each rank fills the rows it owns, zeros
    elsewhere, and one all-reduce adds them (exact: one term per row is
    not zero). [len(ids), F], replicated; the gradient of a rank's block is
    the cotangent of the rows it owns. What the pair scoring reads instead
    of every row."""
    return _GatherById.apply(x, ids, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over the group's ranks; the gradient passes as it is."""
    return _AllReduceSum.apply(x, group)


def grad_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """`x` as it is; its gradient is summed over the group's ranks."""
    return _GradAllReduce.apply(x, group)


def gather_rows(x: torch.Tensor, group, num_rows: int) -> torch.Tensor:
    """Row-sharded blocks `x` [rows_per_shard, ...] of every rank, in rank
    order and cut to `num_rows` rows: replicated. The gradient of a rank's
    block is its own rows of the cotangent."""
    return _GatherRows.apply(x, group, num_rows)


def all_reduce_grads(tensors, group, average: bool = False) -> None:
    """Sum (or average) the `.grad` of each tensor over the group, in
    place: the gradients of replicated parameters whose uses were
    rank-local partial computations. One flat buffer, one collective."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if average:
        flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def max_spread(tensors, group) -> float:
    """The largest |difference| of any element of `tensors` between two
    ranks of the group (0.0 when the ranks hold the same values): each
    rank's values against rank 0's, broadcast."""
    worst, device = 0.0, tensors[0].device
    for t in tensors:
        ref = t.detach().clone().contiguous()
        dist.broadcast(ref, src=dist.get_global_rank(group, 0), group=group)
        worst = max(worst, float((t.detach().float() - ref.float())
                                 .abs().max()) if t.numel() else 0.0)
    spread = torch.tensor([worst], dtype=torch.float64)
    if device.type == "cuda":
        spread = spread.to(device)
    dist.all_reduce(spread, op=dist.ReduceOp.MAX, group=group)
    return float(spread)


def probe(group, device) -> dict:
    """Which collectives the group's backend takes on tensors of `device`:
    name -> "ok", or the error's type and first words. Each result is
    checked against the sum or the rank order it must give; a wrong value
    reads "wrong value"."""
    s, r = dist.get_world_size(group), dist.get_rank(group)
    out = {}

    def attempt(name, fn):
        try:
            out[name] = "ok" if fn() else "wrong value"
        except Exception as e:  # noqa: BLE001 — the probe reports any refusal
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"

    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        mine = torch.full((4, 3), float(r + 1), dtype=dtype, device=device)
        want_sum = s * (s + 1) / 2
        ranks = torch.arange(s, device=device, dtype=dtype).repeat_interleave(4)

        def all_reduce():
            t = mine.clone()
            dist.all_reduce(t, group=group)
            return bool((t == want_sum).all())

        def broadcast():
            t = mine.clone()
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
            return bool((t == 1).all())

        def all_gather_list():
            parts = [torch.empty_like(mine) for _ in range(s)]
            dist.all_gather(parts, mine, group=group)
            return bool((torch.cat(parts)[:, 0] == ranks + 1).all())

        def all_gather_into_tensor(async_op=False):
            t = mine.new_empty((4 * s, 3))
            work = dist.all_gather_into_tensor(t, mine, group=group,
                                               async_op=async_op)
            if async_op:
                work.wait()
            return bool((t[:, 0] == ranks + 1).all())

        def all_to_all_single(async_op=False):
            send = torch.arange(4 * s, device=device, dtype=dtype)[:, None] \
                .repeat(1, 3) + 100 * r
            recv = torch.empty_like(send)
            work = dist.all_to_all_single(recv, send, group=group,
                                          async_op=async_op)
            if async_op:
                work.wait()
            want = (torch.arange(s, device=device) * 100 + 4 * r)[:, None] \
                + torch.arange(4, device=device)[None]
            return bool((recv[:, 0] == want.reshape(-1).to(dtype)).all())

        def reduce_scatter_tensor():
            t = mine.new_empty((4, 3))
            dist.reduce_scatter_tensor(t, mine.repeat(s, 1), group=group)
            return bool((t == want_sum).all())

        attempt(f"all_reduce {tag}", all_reduce)
        attempt(f"broadcast {tag}", broadcast)
        attempt(f"all_gather {tag}", all_gather_list)
        attempt(f"all_gather_into_tensor {tag}", all_gather_into_tensor)
        attempt(f"all_gather_into_tensor async {tag}",
                lambda: all_gather_into_tensor(True))
        attempt(f"all_to_all_single {tag}", all_to_all_single)
        attempt(f"all_to_all_single async {tag}",
                lambda: all_to_all_single(True))
        attempt(f"reduce_scatter_tensor {tag}", reduce_scatter_tensor)

    # the index dtypes of the distributed node2vec: its gathered index
    # blocks and its routed walker frontier
    ids = torch.arange(4 * s, device=device, dtype=torch.int32).reshape(s, 4)

    def gather_index(dtype):
        mine = ((ids[r] + r) % 2).to(dtype) if dtype == torch.bool \
            else ids[r] * 3
        got = all_gather_blocks(mine[:, None].repeat(1, 3), group)
        want = ((ids + torch.arange(s, device=device)[:, None]) % 2).to(
            dtype) if dtype == torch.bool else ids * 3
        return bool((got[:, 0] == want.reshape(-1)).all())

    def all_to_all_index():
        send = ids + 1000 * r  # block j to rank j
        got = all_to_all_blocks(send.reshape(s, 4, 1).repeat(1, 1, 3), group)
        want = ids[r][None, :] + 1000 * torch.arange(s, device=device)[:, None]
        return bool((got[..., 0] == want).all())

    attempt("all_gather_into_tensor int32", lambda: gather_index(torch.int32))
    attempt("all_gather_into_tensor bool", lambda: gather_index(torch.bool))
    attempt("all_to_all_single int32", all_to_all_index)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out
