"""Row sums in a fixed order: `out[index[i]] += src[i]` for every i, where
a row named more than once gets the sum of its terms, added in an order
that does not change from run to run.

`index_add_` adds by atomics on the card, in an order that changes from
run to run, so two runs from one seed can end in different last bits, and
training amplifies them. On the card these functions take
`index_put_(..., accumulate=True)`, which sorts `index` stably and adds
each row's terms in that order; on the CPU they take `index_add_`, which
adds the terms one after another in input order (the CPU's `index_put_`
with `accumulate` adds by atomics once it runs on several threads). The
JAX package's `.at[index].add(src)` is deterministic on the TPU and on
the CPU; these are its counterpart wherever the port adds into rows that
more than one term can reach.
"""

from __future__ import annotations

import torch


def add_rows_(out: torch.Tensor, index: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """`out[index[i]] += src[i]` along dim 0, in place and in a fixed
    order; returns `out`. `index` [E] int64, `src` [E, ...]."""
    if out.is_cuda:
        return out.index_put_((index,), src, accumulate=True)
    return out.index_add_(0, index, src)


def add_rows(out: torch.Tensor, index: torch.Tensor,
             src: torch.Tensor) -> torch.Tensor:
    """`add_rows_` out of place (autograd flows to `out` and `src`)."""
    if out.is_cuda:
        return out.index_put((index,), src, accumulate=True)
    return out.index_add(0, index, src)


def add_gathered_rows_(out: torch.Tensor, index: torch.Tensor,
                       src: torch.Tensor) -> torch.Tensor:
    """`add_rows_` for the gradient of a row gather, whose kernel has
    already held `index` to `[0, len(out))`: on the card the call autograd
    makes for the gradient of `x[index]`, `index_put_` with accumulate and
    without the range check that the public `index_put_` adds (two
    reductions, two compares and two asserts a call)."""
    if out.is_cuda:
        return torch.ops.aten._index_put_impl_(out, (index,), src,
                                               accumulate=True, unsafe=True)
    return add_rows_(out, index, src)


def with_zero_row(x: torch.Tensor) -> torch.Tensor:
    """`x` [N, ...] with a zero row appended at index N: the row that a
    padded slot's sentinel index N reads."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
