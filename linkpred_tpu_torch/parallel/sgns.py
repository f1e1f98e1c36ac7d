"""Distributed SGNS over the ranks of a mesh dim — the counterpart of
`linkpred_tpu/parallel/sgns.py`.

The reference splits the two parallel axes of the embedding fit, and so
does this port, one process per rank:

- **corpus data parallelism** — the walk matrix is row-sharded over the
  ranks of the mesh dim; each rank samples its share (`bc / S`) of the
  step's centers from its own walk rows. The sampled indices (center,
  contexts, validity: one int32 block a rank) are all-gathered, so every
  rank holds the step's whole batch. The samples depend on the corpus
  alone, not on the tables, so a rank draws them for 64 steps at once and
  gathers them in one call (the reference gathers each step's inside its
  scan): a collective and a device sync fewer a step.
- **feature-axis model parallelism** — both embedding tables are sharded on
  the feature dim (`[N, D / S]` a rank). The dot products of the step are
  partial sums over a rank's slice; one all-reduce of the scores (`[Bc,
  nc + P]` f32, the only float collective) makes them whole, and each rank
  then applies the whole batch's update to its own slice
  (`models.word2vec.pooled_update`).

Every rank updates for the same global batch, so the run is the one-process
run of the same sample stream up to float reassociation in the all-reduce:
no table averaging, no staleness. `train_sgns_mesh_reference` replays that
stream in one process and is the tests' oracle.

Random streams (`mesh.stream`): the init is drawn from `(seed, "init")` on
the CPU, so every rank and the replay start from one table; shard `s`
samples from `(seed, "sample", s)` and the negative pools come from
`(seed, "pool")`, the same on every rank, both a chunk of steps at a time.
A draw is then a function of the seed, the shard and the step only, which
is what lets the replay hold one generator per shard seeded as the ranks
are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from linkpred_tpu_torch.models.word2vec import (SGNSConfig, SGNSPrep,
                                                draw_noise, pooled_scores,
                                                pooled_update, prepare_sgns,
                                                sample_pairs)
from linkpred_tpu_torch.parallel.collectives import all_gather_blocks
from linkpred_tpu_torch.parallel.mesh import (dim_rank, dim_size,
                                              make_mesh, mesh_device,
                                              seed_of, stream)

# the names of the three random streams (`mesh.stream`)
_INIT, _SAMPLE, _POOL = 0, 1, 2
# steps whose samples are drawn, and whose index blocks are gathered, at
# once (`_chunks`)
_CHUNK_STEPS = 64


def _cap_batch(cfg: SGNSConfig, num_nodes: int) -> SGNSConfig:
    """The single-device trainer's stability cap: ~16 pair candidates per
    vocabulary entry per step (`models.word2vec.sgns_schedule`)."""
    batch = max(64, min(cfg.batch_size, 16 * num_nodes))
    return dataclasses.replace(cfg, batch_size=batch) \
        if batch != cfg.batch_size else cfg


def _shard_geometry(cfg: SGNSConfig, n_shards: int) -> tuple[int, int]:
    """(context candidates per center, centers per step); the centers
    divide over the shards."""
    nc = max(1, min(cfg.ctx_per_center, cfg.batch_size))
    bc = max(n_shards, cfg.batch_size // nc)
    bc -= bc % n_shards
    return nc, bc


def _steps_and_init(seed: int, num_tokens: int, num_nodes: int,
                    cfg: SGNSConfig, n_shards: int
                    ) -> tuple[int, torch.Tensor]:
    """(SGD steps, the initial input table [num_nodes, dim] f32 on the
    CPU): the reference's step count for a corpus of `num_tokens` tokens,
    and its uniform init in (-0.5, 0.5) / dim, drawn from `(seed, init)`.
    The output table starts at zero."""
    nc, bc = _shard_geometry(cfg, n_shards)
    pairs_per_epoch = num_tokens * cfg.window * 2
    num_steps = max(int(cfg.epochs * pairs_per_epoch / (bc * nc)), 1)
    g = stream(seed, (_INIT,), "cpu")
    w_in = (torch.rand((num_nodes, cfg.dim), generator=g) - 0.5) / cfg.dim
    return num_steps, w_in


def _chunks(lrs: list) -> list:
    """The steps' learning rates in chunks of `_CHUNK_STEPS`."""
    return [lrs[i:i + _CHUNK_STEPS] for i in range(0, len(lrs), _CHUNK_STEPS)]


def _sample_shard(generator: torch.Generator, walks_shard: torch.Tensor,
                  cfg: SGNSConfig, nc: int, bc_local: int,
                  keep: torch.Tensor, steps: int) -> torch.Tensor:
    """`steps` steps' samples from one walk shard, in one draw of the
    single-device sampler (`sample_pairs`): each step's `bc_local` centers,
    their [bc_local, nc] context candidates and validity, packed as one
    int32 block [steps, bc_local, 1 + 2 * nc] (center, contexts, valid)."""
    c, x, v = sample_pairs(
        generator, walks_shard,
        dataclasses.replace(cfg, batch_size=steps * bc_local * nc), keep)
    return torch.cat([c[:, None], x, v.long()], dim=1).int().reshape(
        steps, bc_local, -1)


def _unpack(block: torch.Tensor, nc: int):
    """(center [B], context [B, nc], valid [B, nc]) of a packed block."""
    return (block[:, 0].long(), block[:, 1:1 + nc].long(),
            block[:, 1 + nc:].bool())


def _draw_pool(generator: torch.Generator, noise_J: torch.Tensor,
               noise_q: torch.Tensor, pool_size: int,
               steps: int) -> torch.Tensor:
    """`steps` steps' shared negative pools [steps, pool_size]: the same
    generator state on every rank draws the same pools."""
    return draw_noise(generator, noise_J, noise_q, (steps, pool_size))


# the reference's name for the update of one feature slice from the whole
# scores: the single-device update itself
_slice_update = pooled_update


def _setup(seed, walks, num_nodes, cfg, n_shards, prep, device):
    """The steps both trainers share: the batch cap, the preconditions,
    the corpus trim (the rows beyond a multiple of the shard count, fewer
    than one shard's worth, are dropped, as the reference drops them), the
    noise tables on `device` and the init."""
    cfg = _cap_batch(cfg, num_nodes)
    if cfg.neg_pool <= 0:
        raise ValueError("mesh SGNS requires the pooled negative step "
                         "(neg_pool > 0)")
    if cfg.dim % n_shards:
        raise ValueError(f"dim {cfg.dim} does not divide over {n_shards} "
                         "shards")
    walks = walks if isinstance(walks, torch.Tensor) \
        else torch.as_tensor(np.asarray(walks))
    walks = walks[: (walks.shape[0] // n_shards) * n_shards]
    if prep is None:
        prep = prepare_sgns(walks, num_nodes, cfg)
    tables = tuple(torch.as_tensor(a, device=device)
                   for a in (prep.noise_J, prep.noise_q, prep.keep))
    num_steps, w_in = _steps_and_init(seed, walks.numel(), num_nodes, cfg,
                                      n_shards)
    lrs = np.linspace(cfg.lr, cfg.min_lr, num_steps).tolist()
    return cfg, walks, tables, lrs, w_in


@torch.no_grad()
def train_sgns_mesh(
    seed_or_generator,
    walks,
    num_nodes: int,
    cfg: SGNSConfig = SGNSConfig(),
    mesh: DeviceMesh | None = None,
    axis: str = "data",
    prep: SGNSPrep | None = None,
) -> np.ndarray:
    """Distributed SGNS fit (module docstring), called on every rank of
    `mesh`; returns the input table [num_nodes, dim] f32 on the host, the
    same on every rank.

    `seed_or_generator`: an int, or a `torch.Generator` in the same state
    on every rank (one seed is drawn from it). `walks` [W, L]: the whole
    corpus (numpy or a tensor), the same on every rank; rank k of `axis`
    trains on its k-th block of rows. `mesh` None: a (world, 1) ("data",
    "edge") mesh on the card. Needs `cfg.neg_pool > 0` and `cfg.dim`
    divisible by the size of `axis`."""
    if mesh is None:
        mesh = make_mesh(shape=(dist.get_world_size(), 1))
    device = mesh_device(mesh)
    group = mesh.get_group(axis)
    n_shards, k = dim_size(mesh, axis), dim_rank(mesh, axis)
    seed = seed_of(seed_or_generator)
    cfg, walks, (noise_J, noise_q, keep), lrs, w_in = _setup(
        seed, walks, num_nodes, cfg, n_shards, prep, device)
    nc, bc = _shard_geometry(cfg, n_shards)
    cols = cfg.dim // n_shards
    rows = walks.shape[0] // n_shards

    w_in = w_in[:, k * cols:(k + 1) * cols].contiguous().to(device)
    w_out = torch.zeros_like(w_in)
    walks = walks[k * rows:(k + 1) * rows].to(device)
    sample_gen = stream(seed, (_SAMPLE, k), device)
    pool_gen = stream(seed, (_POOL,), device)
    for chunk in _chunks(lrs):
        mine = _sample_shard(sample_gen, walks, cfg, nc, bc // n_shards,
                             keep, len(chunk))
        # the index exchange: one int32 block a rank for the chunk's steps
        blocks = all_gather_blocks(mine, group).reshape(
            n_shards, len(chunk), -1, mine.shape[-1])
        pools = _draw_pool(pool_gen, noise_J, noise_q, cfg.neg_pool,
                           len(chunk))
        for i, lr in enumerate(chunk):
            center, context, valid = _unpack(
                blocks[:, i].reshape(bc, -1), nc)
            # partial scores over this rank's feature slice, summed
            scores = torch.cat(pooled_scores(w_in, w_out, center, context,
                                             pools[i]), dim=1)
            dist.all_reduce(scores, group=group)
            _slice_update(w_in, w_out, center, context, valid, pools[i], lr,
                          cfg, scores[:, :nc], scores[:, nc:])
    full = all_gather_blocks(w_in, group)  # [S * N, D / S]
    return full.reshape(n_shards, num_nodes, cols).permute(1, 0, 2).reshape(
        num_nodes, cfg.dim).cpu().numpy()


@torch.no_grad()
def train_sgns_mesh_reference(
    seed_or_generator,
    walks,
    num_nodes: int,
    cfg: SGNSConfig,
    n_shards: int,
    prep: SGNSPrep | None = None,
    device=None,
) -> np.ndarray:
    """One-process replay of the mesh run's sample stream on `device`
    (None: the card): one generator per shard seeded as that rank's, the
    shards' samples concatenated (the all-gather), and the pooled step on
    whole tables. Up to float reassociation in the summed scores, this is
    `train_sgns_mesh` over `n_shards` ranks: the oracle of the tests."""
    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    seed = seed_of(seed_or_generator)
    cfg, walks, (noise_J, noise_q, keep), lrs, w_in = _setup(
        seed, walks, num_nodes, cfg, n_shards, prep, device)
    nc, bc = _shard_geometry(cfg, n_shards)
    shards = walks.reshape(n_shards, -1, walks.shape[1]).to(device)
    sample_gens = [stream(seed, (_SAMPLE, s), device)
                   for s in range(n_shards)]
    pool_gen = stream(seed, (_POOL,), device)
    w_in = w_in.to(device)
    w_out = torch.zeros_like(w_in)
    for chunk in _chunks(lrs):
        blocks = torch.stack([
            _sample_shard(g, shard, cfg, nc, bc // n_shards, keep,
                          len(chunk))
            for g, shard in zip(sample_gens, shards)])
        pools = _draw_pool(pool_gen, noise_J, noise_q, cfg.neg_pool,
                           len(chunk))
        for i, lr in enumerate(chunk):
            center, context, valid = _unpack(
                blocks[:, i].reshape(bc, -1), nc)
            pos_score, neg_score = pooled_scores(w_in, w_out, center,
                                                 context, pools[i])
            pooled_update(w_in, w_out, center, context, valid, pools[i], lr,
                          cfg, pos_score, neg_score)
    return w_in.cpu().numpy()
