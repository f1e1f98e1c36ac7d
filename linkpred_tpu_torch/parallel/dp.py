"""Mesh-parallel training steps of the model families — the counterpart of
`linkpred_tpu/parallel/dp.py`.

- **SEAL**: data parallelism. Each rank takes its slice of the subgraph
  batch over every mesh dim (`shard_seal_batch`); the DGCNN parameters are
  replicated and their gradients are averaged over the ranks before each
  optimizer step (`reduce_gradients_on_step`), so the step equals the
  one-process step on the whole batch.
- **TwoWL, edge-sharded**: the ei2 slots (the `e1_*` / `e2_*` columns)
  are split over ``edge``. Each rank builds the composed operands of the
  paired 2-WL aggregation over its contiguous slice of the slots (sorted by
  destination row, so each slice stays sorted); K3 then gives a partial
  `[R, C]` sum that an `all_reduce` completes, and the backward
  `all_reduce`s the ranks' transposed partials (the split's `paired_sum`,
  `sharded_paired_sum`). Everything else is replicated.
- **TwoWL, trial-sharded**: each rank trains its slice of the sweep's trial
  axis (`shard_twowl_trials`); no collective until the results are read.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from linkpred_tpu_torch.models import twowl as m
from linkpred_tpu_torch.ops.segment import gather_sum_composed
from linkpred_tpu_torch.parallel import mesh as mesh_lib
from linkpred_tpu_torch.parallel.collectives import (all_reduce_grads,
                                                     all_reduce_sum,
                                                     grad_all_reduce)
from linkpred_tpu_torch.parallel.multihost import global_put


def seal_batch_spec(mesh: DeviceMesh) -> tuple:
    """The mesh dims the subgraph-batch axis is split over: all of them."""
    return tuple(mesh.mesh_dim_names)


def shard_seal_batch(mesh: DeviceMesh, d_inv, a_tilde, x, node_mask, y,
                     device) -> tuple:
    """This rank's slice of a host subgraph batch (numpy), as tensors on
    `device`; the batch must divide evenly over the mesh."""
    return global_put(mesh, seal_batch_spec(mesh),
                      (d_inv, a_tilde, x, node_mask, y), device)


def replicate(mesh: DeviceMesh, tree: Any):
    """Make every rank hold rank 0's value of each tensor of `tree`
    (dicts, lists, tuples, NamedTuples), in place; returns `tree`."""
    del mesh
    for t in m.tree_leaves(tree._asdict() if hasattr(tree, "_asdict")
                           else tree):
        if isinstance(t, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(t.data, src=0)
    return tree


def reduce_gradients_on_step(optimizer: torch.optim.Optimizer, group,
                             tensors=None, average: bool = True):
    """Before each `optimizer.step()`, sum (`average`: and divide by the
    group's size) the gradients of `tensors` (default: every parameter of
    the optimizer) over `group`, in one collective. Averaging serves
    replicated parameters whose gradient each rank computed whole or on its
    slice of the batch; summing serves replicated parameters whose uses
    were split over row blocks. Either way the ranks then hold one value
    and take one step. Returns the hook's handle."""
    def hook(opt, args, kwargs):
        params = tensors if tensors is not None else [
            p for g in opt.param_groups for p in g["params"]]
        all_reduce_grads(params, group, average=average)

    return optimizer.register_step_pre_hook(hook)


def twowl_split_specs(split) -> dict:
    """Placement contract for a TwoWL split (`data.twowl.TwoWLSplit`) on a
    mesh with an ``edge`` dim: the ei2 direction columns (`e1_*`, `e2_*`)
    are split over ``edge``, everything else is replicated. Returns
    {field: "edge" or None}."""
    return {f.name: ("edge" if f.name.startswith(("e1_", "e2_")) else None)
            for f in dataclasses.fields(split)}


def sharded_paired_sum(group):
    """The paired 2-WL aggregation of a split that holds one rank's slice
    of the ei2 slots: its partial sum (K3 through
    `ops.segment.gather_sum_composed`) completed by an all-reduce over
    `group`, and the gradient of its input by an all-reduce of the ranks'
    transposed partials (every rank holds the same input and loss)."""
    def paired_sum(x, fwd_ops, bwd_ops, kernel):
        part = gather_sum_composed(grad_all_reduce(x, group), fwd_ops,
                                   bwd_ops, kernel)
        return all_reduce_sum(part, group)

    return paired_sum


def shard_twowl_split(mesh: DeviceMesh, split, device) -> m.SplitArrays:
    """A TwoWL split on this rank per `twowl_split_specs`: the paired
    `SplitArrays` over this rank's contiguous slice of the ei2 slots (the
    slot count must divide by the ``edge`` size; build the split with an
    `ei2_bucket` that is a multiple of it), whose `paired_sum` sums the
    ranks' partials over the ``edge`` group."""
    specs = twowl_split_specs(split)
    k, s = mesh_lib.dim_rank(mesh, "edge"), mesh_lib.dim_size(mesh, "edge")
    cut = {name: getattr(split, name)[
        mesh_lib.shard_slice(len(getattr(split, name)), s, k)]
        for name, spec in specs.items() if spec == "edge"}
    arrays = m.SplitArrays.from_split(dataclasses.replace(split, **cut),
                                      device)
    return dataclasses.replace(
        arrays, paired_sum=sharded_paired_sum(mesh.get_group("edge")))


def _slice_trials(tree, axes, k: int, s: int):
    def one(leaf, ax):
        sl = [slice(None)] * leaf.dim()
        sl[ax] = mesh_lib.shard_slice(leaf.shape[ax], s, k)
        return leaf.detach()[tuple(sl)].clone().requires_grad_(
            leaf.requires_grad)

    return m.tree_map(one, tree, axes)


def shard_twowl_trials(mesh: DeviceMesh, params: dict, opt_state,
                       lrs: torch.Tensor, rates: m.TrialRates,
                       axis: str = "data"):
    """This rank's slice of the sweep's trial axis over the mesh dim `axis`:
    the trial-major parameters (each leaf along its own trial axis,
    `models.twowl._trial_axes`), the per-trial Adam state, lrs and dropout
    rates. The trial count must divide evenly. Returns (params, opt_state,
    lrs, rates) for `models.twowl.train_loop_trials`."""
    k, s = mesh_lib.dim_rank(mesh, axis), mesh_lib.dim_size(mesh, axis)
    params_k = _slice_trials(params, m._trial_axes(params), k, s)
    opt_k = _put_opt_like_params(opt_state, params, k, s)
    sl = mesh_lib.shard_slice(lrs.shape[0], s, k)
    return (params_k, opt_k, lrs[sl].clone(),
            m.TrialRates(*(r[sl].clone() for r in rates)))


def _put_opt_like_params(opt_state: m.TrialAdamState, params: dict,
                         k: int, s: int) -> m.TrialAdamState:
    """The per-trial Adam state sliced as the parameters it mirrors (its
    moments have the parameters' layout); the shared count stays."""
    axes = m._trial_axes(params)
    return m.TrialAdamState(mu=_slice_trials(opt_state.mu, axes, k, s),
                            nu=_slice_trials(opt_state.nu, axes, k, s),
                            count=opt_state.count)
