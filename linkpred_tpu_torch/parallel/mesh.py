"""Device meshes over the ranks of a `torch.distributed` world — the
counterpart of `linkpred_tpu/parallel/mesh.py`.

Dims:
- ``data`` — data parallelism: batches of enclosing subgraphs (SEAL),
  trials of the sweep (TwoWL), minibatches of target pairs;
- ``edge`` — graph parallelism: partitions of the edge set or of the node
  rows for SpMM and segment aggregation, combined by collectives over this
  dim's process group.

The reference's `NamedSharding(mesh, P("data"))` / `P()` become the
placement helpers `data_sharding` (this rank's slice of the leading axis
along a named dim) and `replicated` (the whole value): every rank holds
host-replicated numpy data and keeps its own part. Its `fold_in` of a
random key with a shard id becomes `stream`: a generator per (seed, name,
shard).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "edge"),
              device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` over the first `n_devices` ranks of the initialized
    world (default: all of them), with the reference's shape rule: unless
    `shape` is given, ``edge`` gets 2 when the count is even and above 1,
    ``data`` the rest. `device_type` is "cuda" on the card and "cpu" in the
    tests; with gloo as the world's backend every dim's group is gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(distributed.initialize, multihost.initialize_cpu)")
    n = n_devices or dist.get_world_size()
    if n > dist.get_world_size():
        raise ValueError(f"need {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    if shape is None:
        edge = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // edge, edge)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def dim_group(mesh: DeviceMesh, dim: str):
    """The process group of this rank along the mesh dim `dim`."""
    return mesh.get_group(dim)


def dim_rank(mesh: DeviceMesh, dim) -> int:
    """This rank's coordinate along `dim` (a name, or a tuple of names taken
    as one flattened dim, outermost first)."""
    dims = (dim,) if isinstance(dim, str) else tuple(dim)
    coord, names = 0, mesh.mesh_dim_names
    for d in dims:
        coord = coord * mesh.size(names.index(d)) + mesh.get_local_rank(d)
    return coord


def dim_size(mesh: DeviceMesh, dim) -> int:
    dims = (dim,) if isinstance(dim, str) else tuple(dim)
    names = mesh.mesh_dim_names
    return int(np.prod([mesh.size(names.index(d)) for d in dims]))


def shard_slice(n: int, parts: int, index: int) -> slice:
    """The `index`-th of `parts` equal contiguous slices of `n` items;
    `n` must divide evenly."""
    if n % parts:
        raise ValueError(f"{n} items do not divide into {parts} shards")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def data_sharding(mesh: DeviceMesh, x, dim="data"):
    """This rank's slice of `x` along its leading axis over the mesh dim
    `dim` (a name or a tuple of names): the reference's `P("data")`."""
    return x[shard_slice(x.shape[0], dim_size(mesh, dim), dim_rank(mesh, dim))]


def replicated(mesh: DeviceMesh, x):
    """`x` whole on every rank: the reference's `P()`."""
    return x


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device for a mesh: its current card for a "cuda" mesh
    (`cuda_device()`, which raises without one), else the CPU."""
    if mesh.device_type == "cuda":
        from linkpred_tpu_torch.utils.device import cuda_device

        return cuda_device()
    return torch.device(mesh.device_type)


def stream(seed: int, ids: Sequence[int], device) -> torch.Generator:
    """A `torch.Generator` on `device` seeded from `seed` and `ids` (a
    stream's name and, say, a shard id) through numpy's `SeedSequence`, so
    that distinct `ids` give independent streams: the reference's
    `fold_in` of a key."""
    state = np.random.SeedSequence([int(seed), *map(int, ids)])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


def seed_of(seed_or_generator) -> int:
    """An int seed: `seed_or_generator` itself, or one draw from a
    `torch.Generator` (every rank passes one in the same state, so every
    rank reads the same seed)."""
    if isinstance(seed_or_generator, torch.Generator):
        g = seed_or_generator
        return int(torch.randint(0, 2**62, (1,), generator=g,
                                 device=g.device))
    return int(seed_or_generator)
