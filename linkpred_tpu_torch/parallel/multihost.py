"""Multi-process jobs, placement of host data and synchronisation — the
counterpart of `linkpred_tpu/parallel/multihost.py`.

Every rank runs the same program on host-replicated numpy data and keeps
its own part of it (`global_put`), as each JAX process materialises only
its addressable shards. The placement contracts are `dp.twowl_split_specs`
and `dp.seal_batch_spec`, shared with the one-process path.

- `initialize_cpu(init_dir, num_processes, process_id)`: the gloo form of
  `distributed.initialize`, with a `file://` rendezvous under a directory
  the caller gives (so that parallel test workers never race for a port).
  Ranks may still put CUDA tensors through it: that is gloo on CUDA, named.
- `launch(fn, world_size, workdir, args)`: start `world_size` spawned
  processes that join one gloo job and each run `fn(rank, world_size,
  *args)`; returns their results. A rank that fails fails the launch.
- `global_mesh`, `global_put`, `global_twowl_split`: the mesh and the
  placement of host data; `fetch_replicated` (rank 0's value, broadcast,
  back on the host) and `sync` (a barrier) as in the reference.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import time
import traceback
import uuid
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from linkpred_tpu_torch.parallel import mesh as mesh_lib


def initialize_cpu(init_dir: str, num_processes: int, process_id: int,
                   timeout_s: float = 300.0, name: str = "rendezvous") -> None:
    """Join a gloo job of `num_processes` processes through the file
    `init_dir/name` (every process passes the same directory and name)."""
    path = os.path.abspath(os.path.join(init_dir, name))
    dist.init_process_group(
        "gloo", init_method=f"file://{path}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(fn, rank, world, workdir, name, args, threads):
    torch.set_num_threads(threads)
    try:
        initialize_cpu(workdir, world, rank, name=name)
        result = fn(rank, world, *args)
        with open(os.path.join(workdir, f"{name}.result{rank}"), "wb") as f:
            pickle.dump(result, f)
        sync("launch done")
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"{name}.error{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(fn, world_size: int, workdir: str, args: tuple = (),
           expect_rc: int = 0, timeout_s: float = 900.0,
           threads: int = 1) -> list:
    """Run `fn(rank, world_size, *args)` in `world_size` spawned processes
    that form one gloo job (`initialize_cpu` under `workdir`), each with
    `threads` torch threads. `fn` must be importable by name from a module
    that a fresh interpreter can load. Returns each rank's return value
    (pickled through `workdir`), or None for a rank that exited with
    `expect_rc` before returning. Raises when a rank exits with another
    code (with every rank's traceback) or when the job outlasts
    `timeout_s`; the other ranks are then stopped."""
    os.makedirs(workdir, exist_ok=True)
    name = f"job-{uuid.uuid4().hex[:12]}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, workdir, name, args,
                               threads))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    failed_at = None
    try:
        while any(p.exitcode is None for p in procs):
            live = [p.sentinel for p in procs if p.exitcode is None]
            multiprocessing.connection.wait(live, timeout=1.0)
            now = time.monotonic()
            if failed_at is None and any(
                    p.exitcode not in (None, 0, expect_rc) for p in procs):
                failed_at = now  # the others may wait in a collective
            if now > deadline or (failed_at is not None
                                  and now - failed_at > 20.0):
                break
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
        for p in procs:
            p.join(10)
    rcs = [p.exitcode for p in procs]
    if any(rc not in (0, expect_rc) for rc in rcs):
        errors = []
        for r in range(world_size):
            path = os.path.join(workdir, f"{name}.error{r}")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"--- rank {r} ---\n{f.read()}")
        raise RuntimeError(f"launch: ranks exited with {rcs} (expected "
                           f"{expect_rc})\n" + "\n".join(errors))
    results = []
    for r in range(world_size):
        path = os.path.join(workdir, f"{name}.result{r}")
        if os.path.exists(path):
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        else:
            results.append(None)
    return results


def global_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
                device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the first prod(`shape`) ranks of the world, rank-major,
    so the leading dim falls on the process boundary."""
    n = int(np.prod(shape))
    if dist.get_world_size() < n:
        raise ValueError(f"need {n} ranks, have {dist.get_world_size()}")
    return mesh_lib.make_mesh(n, shape, axis_names, device_type)


def _place(leaf, spec, mesh: DeviceMesh, device):
    arr = np.asarray(leaf)
    if spec is not None:
        arr = mesh_lib.data_sharding(mesh, arr, spec)
    return torch.as_tensor(np.ascontiguousarray(arr), device=device)


def global_put(mesh: DeviceMesh, spec: Any, tree: Any, device):
    """Tensors on `device` from host-replicated numpy data: each leaf whole
    (`spec` None, the reference's `P()`) or this rank's slice of its leading
    axis over the mesh dim(s) `spec` (a name or a tuple of names, as
    `P("data")` / `P(("host", "data", "edge"))`). `spec` may also be a dict
    keyed like `tree` (a dict or a NamedTuple)."""
    if isinstance(spec, dict):
        items = tree._asdict() if hasattr(tree, "_asdict") else tree
        placed = {k: _place(v, spec[k], mesh, device)
                  for k, v in items.items()}
        return type(tree)(**placed) if hasattr(tree, "_asdict") else placed
    if isinstance(tree, dict):
        return {k: global_put(mesh, spec, v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_asdict"):
        return type(tree)(global_put(mesh, spec, v, device) for v in tree)
    if hasattr(tree, "_asdict"):
        return type(tree)(*(global_put(mesh, spec, v, device) for v in tree))
    return _place(tree, spec, mesh, device)


def global_twowl_split(mesh: DeviceMesh, split, device):
    """`dp.shard_twowl_split` for the multi-process regime: the same
    placement contract (`dp.twowl_split_specs`)."""
    from linkpred_tpu_torch.parallel import dp

    return dp.shard_twowl_split(mesh, split, device)


def fetch_replicated(tree: Any, group=None):
    """Host numpy values of a replicated tree (tensors in dicts, lists,
    tuples): rank 0's copy of each leaf, broadcast to every rank, so all
    ranks read one value."""
    if isinstance(tree, dict):
        return {k: fetch_replicated(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_replicated(v, group) for v in tree) \
            if not hasattr(tree, "_asdict") else \
            type(tree)(*(fetch_replicated(v, group) for v in tree))
    if not isinstance(tree, torch.Tensor):
        return np.asarray(tree)
    t = tree.detach().contiguous().clone()
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        src = dist.get_global_rank(group, 0) if group is not None else 0
        dist.broadcast(t, src=src, group=group)
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def sync(name: str = "sync") -> None:
    """Barrier over the world (a no-op in one process). `name` labels the
    call site for the reader."""
    del name
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
