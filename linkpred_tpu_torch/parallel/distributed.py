"""Joining a multi-process job and the host-outer mesh — the counterpart
of `linkpred_tpu/parallel/distributed.py`.

`initialize()` joins the job that `torchrun` describes in the environment
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`) and puts this process on its card; with no such environment
it does nothing and returns False, as the reference's no-op does:

    torchrun --nproc-per-node N -m linkpred_tpu_torch.cli scale --family gcn

There is no fallback. `device_type=None` is the card, and raises when none
is visible: a CPU job names `device_type="cpu"`. `backend=None` is NCCL for
CUDA and gloo for the CPU; gloo on CUDA tensors runs only when the caller
names it. A host with more
ranks than visible cards raises: ranks are not remapped onto fewer cards
and the backend is not changed.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def initialize(backend: str | None = None, device_type: str | None = None,
               timeout_s: float = 600.0) -> bool:
    """Join the job described by the environment; True when this process
    now runs distributed. `device_type` is "cuda" (the default, which
    raises when no card is visible) or "cpu"; on "cuda" this process takes
    card `LOCAL_RANK`. Safe to call twice, and a no-op (False) without
    `RANK` and `WORLD_SIZE`."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    if dist.is_initialized():
        return True
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; a CPU job joins with "
                'initialize(device_type="cpu")')
        device_type = "cuda"
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    local_rank = int(env.get("LOCAL_RANK", 0))
    if device_type == "cuda":
        local_world = int(env.get("LOCAL_WORLD_SIZE", local_rank + 1))
        cards = torch.cuda.device_count()
        if max(local_world, local_rank + 1) > cards:
            raise RuntimeError(
                f"{local_world} ranks on this host and {cards} visible "
                f"card(s): {backend} runs one rank per card; start at most "
                f"{cards} (torchrun --nproc-per-node {cards})")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s),
        device_id=(torch.device("cuda", local_rank)
                   if backend == "nccl" else None))
    return True


def hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int] = (1,),
                axis_names: Sequence[str] = ("host", "data", "edge"),
                device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` whose outer dims span hosts and inner dims the ranks
    of one host: shape `dcn_shape + ici_shape`, host-major, so the outer
    dim falls on the host boundary (`torchrun` numbers a host's ranks
    contiguously). The chatty collectives (the edge aggregation) then stay
    on a host's links; the outer dims carry the data-parallel gradient
    reduction."""
    shape = tuple(dcn_shape) + tuple(ici_shape)
    n = int(np.prod(shape))
    if n > dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names[: len(shape)]))


def finish() -> None:
    """Leave the job: a barrier, then the process group is destroyed."""
    dist.barrier()
    dist.destroy_process_group()
