"""End-to-end GCN link-prediction training at ogbl-collab scale on one card —
the counterpart of the single-device path of
`linkpred_tpu/pipelines/gcn_scale.py` (BASELINE config 5).

A 2-layer GCN link predictor over a ~235k-node power-law graph: node inputs
from a learnable embedding table, both aggregations on the symmetric-
normalised adjacency in the degree-bucketed layout (kernel K3,
`ops.spmm.spmm_bucketed_sym`, whose backward is the same aggregation), edge
scores as dots of endpoint representations (kernel K2, `ops.sddmm.
sddmm_coo`), BCE over positive and negative edge batches, Adam.

`train_collab` composes the module functions: `build_problem` (host numpy,
equal to the reference's), `init_params`, `train_and_score` (warm-up on a
throwaway copy, then the timed `train_steps` and `test_logits`).
`train_steps` and `test_logits` take the aggregation and the scoring
function as arguments, so the same steps can run on the kernels' plain
versions (`spmm_bucketed_sym_reference`, `sddmm_reference`) for comparison.

Over a mesh of several ranks (`train_collab(mesh=...)`, or the world that
`torchrun` started) every rank owns a block of node rows: its rows of the
embedding table, of both layers' activations and of the output. The
aggregations run on K3 over the rank's block, either `node_sharded`
(`parallel.spmm_shard.spmm_node_sharded_sym` on the all-gathered input) or
`halo` (`parallel.halo.spmm_halo_sym`, only the cut's rows exchanged, over
a locality ordering of the nodes). The pair scoring gathers the rows its
pairs name (`parallel.collectives.gather_by_id`) and runs K2 on them on
every rank; the gradients of the replicated weights are summed over the
ranks before each Adam step. Rank 0 builds the problem and the layout and
broadcasts them.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.data.io import load_edge_pairs
from linkpred_tpu_torch.data.split import negative_sampling
from linkpred_tpu_torch.data.synth import (synth_community_graph,
                                           synth_powerlaw_graph)
from linkpred_tpu_torch.ops.sddmm import sddmm_coo
from linkpred_tpu_torch.ops.spmm import BucketedEll, spmm_bucketed_sym
from linkpred_tpu_torch.utils.metrics import roc_auc_score
from linkpred_tpu_torch.utils.profiling import ThroughputCounter


@dataclasses.dataclass(frozen=True)
class ScaleGCNConfig:
    nodes: int = 235_000
    edges: int = 1_280_000
    max_degree: int = 64
    emb_dim: int = 64
    hidden: int = 128
    steps: int = 60
    batch_edges: int = 8192
    test_fraction: float = 0.02
    learning_rate: float = 5e-3
    dtype: str = "bf16"  # aggregation/feature dtype; params stay f32
    seed: int = 0
    # "node_sharded": each rank aggregates its rows from the all-gathered
    # input (one card: the bucketed path). "halo": boundary-only exchange
    # over a locality ordering (parallel.halo), collectives that follow the
    # edge cut instead of N*F; it needs a mesh
    aggregation: str = "node_sharded"
    graph: str = "powerlaw"  # or "community" (clustered, collab-like)
    # a real edge dump (`cli scale --edges-file`, read by
    # data.io.load_edge_pairs) replaces the synthetic graph
    edges_file: str | None = None


def feature_dtype(cfg: ScaleGCNConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bf16" else torch.float32


def resolve_graph_source(cfg: ScaleGCNConfig):
    """`(cfg, (lo, hi) | None)`: when `cfg.edges_file` is set, load the real
    edge dump and rewrite nodes/edges from it."""
    if not cfg.edges_file:
        return cfg, None
    lo, hi, n = load_edge_pairs(cfg.edges_file)
    return dataclasses.replace(cfg, nodes=n, edges=len(lo)), (lo, hi)


def build_problem(cfg: ScaleGCNConfig, pairs_override=None):
    """Collab-scale graph (synthetic or a real edge dump), train/test edge
    split, and the symmetric-capped, symmetric-normalised message graph.

    Returns `(graph, train_pos, test_pos, test_neg)`, all host numpy and
    array-equal to the reference's: the port's copies of its host modules
    are called in the same order on the same
    `np.random.default_rng(cfg.seed)`."""
    rng = np.random.default_rng(cfg.seed)
    if pairs_override is not None:
        lo, hi = pairs_override
    else:
        synth = (synth_community_graph if cfg.graph == "community"
                 else synth_powerlaw_graph)
        lo, hi = synth(cfg.nodes, cfg.edges, seed=cfg.seed)
    pairs = np.stack([lo, hi], axis=1)
    perm = rng.permutation(len(pairs))
    n_test = int(len(pairs) * cfg.test_fraction)
    test_pos = pairs[perm[:n_test]]
    train_pos = pairs[perm[n_test:]]
    test_neg = negative_sampling(pairs, cfg.nodes, n_test, rng=rng)

    # message graph = train positives only. The cap drops whole undirected
    # pairs, so the capped pattern stays symmetric: the aggregation's
    # backward reuses the forward as A^T, right only for A == A^T.
    g = Graph.from_undirected_edges(
        train_pos[:, 0], train_pos[:, 1], num_nodes=cfg.nodes
    ).with_degree_cap(cfg.max_degree, rng=rng, symmetric=True)

    # symmetric GCN normalisation w_ij = 1/sqrt((d_i+1)(d_j+1))
    d = np.asarray(g.degree, np.float64) + 1.0
    inv_sqrt = (1.0 / np.sqrt(d)).astype(np.float32)
    w = inv_sqrt[:, None] * inv_sqrt[np.asarray(g.nbr)]
    g = dataclasses.replace(g, nbr_weight=np.ascontiguousarray(w))
    return g, train_pos, test_pos, test_neg


def batch_schedule(cfg: ScaleGCNConfig, train_pos: np.ndarray) -> np.ndarray:
    """Every step's edges, drawn as the reference draws them from
    `np.random.default_rng(cfg.seed + 1)`: [S, 2, 2B] int32, row 0 the
    sources and row 1 the destinations of B positives then B negatives."""
    rng = np.random.default_rng(cfg.seed + 1)
    B, S = cfg.batch_edges, cfg.steps
    pos_b = train_pos[rng.integers(0, len(train_pos), (S, B))].astype(np.int32)
    neg_b = rng.integers(0, cfg.nodes, (S, B, 2)).astype(np.int32)
    both = np.concatenate([pos_b, neg_b], axis=1)  # [S, 2B, 2]
    return np.ascontiguousarray(both.transpose(0, 2, 1))


def init_params(cfg: ScaleGCNConfig, generator: torch.Generator,
                device) -> dict:
    """The reference's parameters (embedding table N(0, 0.1^2), Glorot
    weights), drawn on the host from a CPU `generator`, as f32 leaf tensors
    on `device` that require grad."""

    def glorot(shape):
        lim = float(np.sqrt(6.0 / (shape[0] + shape[1])))
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * lim

    params = {
        "emb": torch.randn((cfg.nodes, cfg.emb_dim), generator=generator) * 0.1,
        "w1": glorot((cfg.emb_dim, cfg.hidden)),
        "w1s": glorot((cfg.emb_dim, cfg.hidden)),
        "w2": glorot((cfg.hidden, cfg.hidden)),
        "w2s": glorot((cfg.hidden, cfg.hidden)),
    }
    return {k: v.to(device).requires_grad_() for k, v in params.items()}


def params_from_jax(params, device) -> dict:
    """The reference's parameter dict (leaves as numpy arrays, e.g.
    `jax.tree_util.tree_map(np.asarray, params)`) as this module's."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=device).requires_grad_()
            for k, v in params.items()}


def adam(params: dict, learning_rate: float) -> torch.optim.Adam:
    """Adam over every parameter; its defaults (betas 0.9/0.999, eps 1e-8,
    no weight decay) are optax's `adam(learning_rate)`."""
    return torch.optim.Adam(list(params.values()), lr=learning_rate, eps=1e-8)


def embed_all(params: dict, operands: tuple, cfg: ScaleGCNConfig,
              aggregate=spmm_bucketed_sym) -> torch.Tensor:
    """Node representations [N, hidden] in the feature dtype; parameters
    stay f32 and are cast at each use, as in the reference."""
    dtype = feature_dtype(cfg)
    x = params["emb"].to(dtype)
    a1 = aggregate(x, cfg.nodes, operands)
    h = torch.relu(a1 @ params["w1"].to(dtype) + x @ params["w1s"].to(dtype))
    a2 = aggregate(h, cfg.nodes, operands)
    return a2 @ params["w2"].to(dtype) + h @ params["w2s"].to(dtype)


def loss_fn(params: dict, batch: torch.Tensor, operands: tuple,
            cfg: ScaleGCNConfig, aggregate=spmm_bucketed_sym,
            score=sddmm_coo) -> torch.Tensor:
    """BCE with logits, mean over the 2B edges of `batch` [2, 2B] (B
    positives, then B negatives), as optax's `sigmoid_binary_cross_entropy`."""
    h = embed_all(params, operands, cfg, aggregate)
    logits = score(batch[0], batch[1], h).float()
    b = batch.shape[1] // 2
    labels = torch.cat([logits.new_ones(b), logits.new_zeros(b)])
    return F.binary_cross_entropy_with_logits(logits, labels)


def train_steps(params: dict, optimizer: torch.optim.Optimizer,
                batches: torch.Tensor, operands: tuple, cfg: ScaleGCNConfig,
                aggregate=spmm_bucketed_sym, score=sddmm_coo) -> torch.Tensor:
    """One Adam step per batch of `batches` [S, 2, 2B]; returns the losses
    [S] on the device, read by no step (the loop never waits on the card)."""
    losses = torch.empty(batches.shape[0], device=batches.device)
    for s in range(batches.shape[0]):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batches[s], operands, cfg, aggregate, score)
        loss.backward()
        optimizer.step()
        losses[s] = loss.detach()
    return losses


def test_logits(params: dict, pairs: torch.Tensor, operands: tuple,
                cfg: ScaleGCNConfig, aggregate=spmm_bucketed_sym,
                score=sddmm_coo) -> torch.Tensor:
    """f32 scores [T] of the pairs `pairs` [2, T]."""
    with torch.no_grad():
        h = embed_all(params, operands, cfg, aggregate)
        return score(pairs[0], pairs[1], h).float()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


WARMUP_STEPS = 2


def train_and_score(cfg: ScaleGCNConfig, problem: tuple, operands: tuple,
                    params: dict, device, aggregate=spmm_bucketed_sym,
                    score=sddmm_coo, optimizer=adam,
                    return_losses: bool = False, pair_map=None):
    """Train `params` (in place) for `cfg.steps` Adam steps on `problem`
    (`build_problem`'s tuple; `operands` its layout on `device`), then
    score the test pairs. The timed steps start from the given parameters:
    the warm-up (kernel builds, cuBLAS set-up, the allocator's first
    growth) runs `WARMUP_STEPS` steps on a throwaway copy and is reported as
    `compile_seconds`. `optimizer(params, lr)` makes the optimizer;
    `pair_map` [N], when given, renames every node id of the step batches
    and the test pairs (the halo layout's `inv_perm`), after they are drawn.
    Returns the reference's keys but `build_seconds`, and with
    `return_losses` the step losses [S] (numpy) beside them."""
    device = torch.device(device)
    g, train_pos, test_pos, test_neg = problem

    def mapped(pairs):
        return pairs if pair_map is None else pair_map[pairs].astype(np.int32)

    batches = torch.from_numpy(mapped(batch_schedule(cfg, train_pos))).to(
        device)
    S = cfg.steps

    t0 = time.perf_counter()
    warm = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    train_steps(warm, optimizer(warm, cfg.learning_rate),
                batches[:WARMUP_STEPS], operands, cfg, aggregate, score)
    _sync(device)
    del warm
    compile_seconds = time.perf_counter() - t0

    # 4 aggregation passes per step: 2 forward + 2 symmetric backward
    counter = ThroughputCounter(unit="agg-edges")
    opt = optimizer(params, cfg.learning_rate)
    with counter.span(4 * g.num_edges * S):
        losses = train_steps(params, opt, batches, operands, cfg,
                             aggregate, score)
        _sync(device)
    losses = losses.cpu().numpy()

    both = mapped(np.concatenate([test_pos, test_neg]).astype(np.int32))
    pairs = torch.from_numpy(np.ascontiguousarray(both.T)).to(device)
    scores = test_logits(params, pairs, operands, cfg, aggregate, score)
    y = np.concatenate([np.ones(len(test_pos)), np.zeros(len(test_neg))])
    auc = roc_auc_score(y, scores.cpu().numpy())

    first_q = float(losses[: max(S // 4, 1)].mean())
    last_q = float(losses[-max(S // 4, 1):].mean())
    out = {
        "nodes": cfg.nodes,
        "directed_edges": int(g.num_edges),
        "shards": 1,
        "aggregation": cfg.aggregation,
        "steps": S,
        "loss_first_quarter": first_q,
        "loss_last_quarter": last_q,
        "loss_decreased": bool(last_q < first_q),
        "test_auc": float(auc),
        "train_seconds": round(counter.seconds, 3),
        "compile_seconds": round(compile_seconds, 1),
        "steps_per_s": round(S / counter.seconds, 2),
        "agg_edges_per_s": round(counter.rate),
    }
    if return_losses:
        return out, losses
    return out


def _one_card(cfg: ScaleGCNConfig, device) -> dict:
    if cfg.aggregation == "halo":
        raise ValueError(
            "aggregation='halo' splits the graph over the ranks of a mesh: "
            "pass mesh= or start the ranks with torchrun --nproc-per-node N")
    t0 = time.perf_counter()
    cfg, pairs_override = resolve_graph_source(cfg)
    problem = build_problem(cfg, pairs_override)
    operands = BucketedEll.from_graph(problem[0]).operands(device)
    build_seconds = time.perf_counter() - t0
    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed), device)
    out = train_and_score(cfg, problem, operands, params, device)
    out["build_seconds"] = round(build_seconds, 1)
    return out


def build_sharded(cfg: ScaleGCNConfig, n_shards: int,
                  problem: tuple | None = None) -> dict:
    """What every rank needs, built on the host once: the problem's pairs
    and edge count, and the layout of `cfg.aggregation` for `n_shards`
    ranks. `problem` is `build_problem`'s tuple when it was built already.
    `build_seconds` is the problem's build, `layout_seconds` the layout's.

    The halo layout relabels the nodes (`train_sharded` renames the pairs
    and the embedding rows)."""
    from linkpred_tpu_torch.parallel.halo import HaloLayout
    from linkpred_tpu_torch.parallel.spmm_shard import (
        build_node_sharded_buckets)

    t0 = time.perf_counter()
    cfg, pairs_override = resolve_graph_source(cfg)
    if problem is None:
        problem = build_problem(cfg, pairs_override)
    g, train_pos, test_pos, test_neg = problem
    t1 = time.perf_counter()
    out = {"cfg": cfg, "num_edges": int(g.num_edges)}
    if cfg.aggregation == "halo":
        lay = HaloLayout.build(g, n_shards)
        out["layout"] = lay
        out["rows_per_shard"] = lay.rows_per_shard
    else:
        rows, _, stacked = build_node_sharded_buckets(g, n_shards)
        out["stacked"], out["rows_per_shard"] = stacked, rows
    out.update(train_pos=train_pos, test_pos=test_pos, test_neg=test_neg,
               build_seconds=t1 - t0,
               layout_seconds=time.perf_counter() - t1)
    return out


def shard_params(params: dict, rank: int, rows: int) -> dict:
    """Full parameters (`init_params`, `params_from_jax`) as one rank's:
    its block of embedding rows (zero rows past the table's end) and the
    weights whole, as new leaves that require grad."""
    emb = params["emb"].detach()
    block = emb[rank * rows:(rank + 1) * rows]
    if block.shape[0] < rows:
        block = torch.cat([block, block.new_zeros(
            (rows - block.shape[0], emb.shape[1]))])
    out = {k: v.detach().clone() for k, v in params.items() if k != "emb"}
    out["emb"] = block.clone()
    return {k: v.requires_grad_() for k, v in out.items()}


def train_sharded(cfg: ScaleGCNConfig, mesh, device,
                  built: dict | None = None, params: dict | None = None,
                  reference_draw: bool = False):
    """`train_collab` over the ``edge`` dim of `mesh`, called by every rank
    of it: (the result, this rank's trained parameters (its embedding
    block and the weights), the step losses [S] as numpy). `built` is
    `build_sharded`'s dict (None: rank 0 of the world builds it and
    broadcasts it); `params` full `init_params` parameters (None: the
    seeded init).

    A halo run works in the layout's relabelled ids. By default every pair
    is drawn in the problem's ids and then renamed through `inv_perm`, and
    the embedding rows are renamed with the nodes: the run is then the
    very run a one-card run of the same parameters and seed makes, so its
    losses can be held to that run's step by step (ROADMAP F8).
    `reference_draw` draws as the reference does: the stored pairs renamed
    once, the step negatives drawn in the relabelled ids and `params` taken
    as given in those ids, another sample of the same distribution."""
    import torch.distributed as dist

    from linkpred_tpu_torch.parallel.collectives import (gather_by_id,
                                                         gather_rows)
    from linkpred_tpu_torch.parallel.dp import reduce_gradients_on_step
    from linkpred_tpu_torch.parallel.halo import spmm_halo_sym
    from linkpred_tpu_torch.parallel.mesh import dim_rank, dim_size
    from linkpred_tpu_torch.parallel.spmm_shard import (
        node_sharded_operands, spmm_node_sharded_sym)

    group = mesh.get_group("edge")
    n_shards, rank = dim_size(mesh, "edge"), dim_rank(mesh, "edge")
    if built is None:
        box = [build_sharded(cfg, n_shards) if dist.get_rank() == 0
               else None]
        dist.broadcast_object_list(box, src=0)
        built = box[0]
    cfg, rows = built["cfg"], built["rows_per_shard"]
    pair_map = None
    if cfg.aggregation == "halo":
        lay = built["layout"]
        ops = lay.operands(rank, device)
        if reference_draw:
            built = dict(built, **{k: lay.inv_perm[built[k]] for k in (
                "train_pos", "test_pos", "test_neg")})
        else:
            pair_map = lay.inv_perm

        def aggregate(x, num_nodes, ops_):
            return spmm_halo_sym(group, x, ops_)
    else:
        ops = node_sharded_operands(built["stacked"], rank, device)

        def aggregate(x, num_nodes, ops_):
            return spmm_node_sharded_sym(
                group, gather_rows(x, group, num_nodes), num_nodes, rows,
                ops_)

    def score(src, dst, h):
        # the rows the pairs name, gathered from their owners, then K2
        t = gather_by_id(h, torch.cat([src, dst]), group)
        ids = torch.arange(src.shape[0], device=h.device, dtype=torch.int32)
        return sddmm_coo(ids, ids + src.shape[0], t)

    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                             device)
    if pair_map is not None:
        params = dict(params, emb=params["emb"].detach()[
            torch.as_tensor(lay.order, device=params["emb"].device)])
    local = shard_params(params, rank, rows)

    def optimizer(p, lr):
        opt = adam(p, lr)
        # the weights' uses were split over the ranks' row blocks: sum
        reduce_gradients_on_step(opt, group, [p[k] for k in
                                              ("w1", "w1s", "w2", "w2s")],
                                 average=False)
        return opt

    # `train_and_score` reads one field of the graph: its edge count
    problem = (SimpleNamespace(num_edges=built["num_edges"]),
               built["train_pos"], built["test_pos"], built["test_neg"])
    out, losses = train_and_score(
        cfg, problem, ops, local, device, aggregate, score, optimizer,
        return_losses=True, pair_map=pair_map)
    out.update(shards=n_shards, build_seconds=round(built["build_seconds"], 1),
               layout_seconds=round(built["layout_seconds"], 1))
    if cfg.aggregation == "halo":
        out.update(ghost_capacity=lay.ghost_capacity, edge_cut=lay.edge_cut,
                   num_hubs=lay.num_hubs, hub_capacity=lay.hub_capacity)
    return out, local, losses


def train_collab(cfg: ScaleGCNConfig = ScaleGCNConfig(), device=None,
                 mesh=None, verbose: bool = True) -> dict:
    """Train end-to-end; returns losses, test AUC and throughput under the
    reference's keys.

    `device`: default the visible card (set per rank by
    `parallel.distributed.initialize`); no card raises. `mesh`: a
    `DeviceMesh` whose ``edge`` dim splits the node rows (default: the
    initialized world as a (1, world) mesh, as the reference takes every
    device). One shard runs today's one-card path; several run
    `cfg.aggregation` ("node_sharded" or "halo") over the ranks, every rank
    calling this function (`train_sharded`; rank 0 builds the problem and
    the layout and broadcasts them). Without a process group a process that
    sees several cards raises: start one rank per card with torchrun."""
    import torch.distributed as dist

    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    if mesh is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from linkpred_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(shape=(1, dist.get_world_size()),
                         device_type=device.type)
    if mesh is None and device.type == "cuda" \
            and torch.cuda.device_count() > 1:
        raise RuntimeError(
            f"{torch.cuda.device_count()} cards are visible and no process "
            "group is initialized: start one rank per card with torchrun "
            "--nproc-per-node N -m linkpred_tpu_torch.cli scale --family "
            "gcn (or make one card visible)")
    n_shards = 1 if mesh is None else mesh.size(
        mesh.mesh_dim_names.index("edge"))
    if n_shards == 1:
        out = _one_card(cfg, device)
    else:
        out = train_sharded(cfg, mesh, device)[0]
    if verbose:
        print(f"collab-scale GCN: loss {out['loss_first_quarter']:.4f} -> "
              f"{out['loss_last_quarter']:.4f}, test AUC "
              f"{out['test_auc']:.4f}, {out['steps_per_s']} steps/s, "
              f"{out['agg_edges_per_s'] / 1e6:.0f}M agg-edges/s on "
              f"{n_shards} shard(s) ({device})")
    return out
