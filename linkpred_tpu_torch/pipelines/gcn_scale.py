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
The reference's node-sharded and halo multi-device paths are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

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
    # "node_sharded" is the one-card bucketed path here; "halo" (the
    # reference's boundary-exchange multi-device path) raises
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
                    score=sddmm_coo) -> dict:
    """Train `params` (in place) for `cfg.steps` Adam steps on `problem`
    (`build_problem`'s tuple; `operands` its layout on `device`), then
    score the test pairs. The timed steps start from the given parameters:
    the warm-up (kernel builds, cuBLAS set-up, the allocator's first
    growth) runs `WARMUP_STEPS` steps on a throwaway copy and is reported as
    `compile_seconds`. Returns the reference's keys but `build_seconds`."""
    device = torch.device(device)
    g, train_pos, test_pos, test_neg = problem
    batches = torch.from_numpy(batch_schedule(cfg, train_pos)).to(device)
    S = cfg.steps

    t0 = time.perf_counter()
    warm = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    train_steps(warm, adam(warm, cfg.learning_rate), batches[:WARMUP_STEPS],
                operands, cfg, aggregate, score)
    _sync(device)
    del warm
    compile_seconds = time.perf_counter() - t0

    # 4 aggregation passes per step: 2 forward + 2 symmetric backward
    counter = ThroughputCounter(unit="agg-edges")
    optimizer = adam(params, cfg.learning_rate)
    with counter.span(4 * g.num_edges * S):
        losses = train_steps(params, optimizer, batches, operands, cfg,
                             aggregate, score)
        _sync(device)
    losses = losses.cpu().numpy()

    both = np.concatenate([test_pos, test_neg]).astype(np.int32)
    pairs = torch.from_numpy(np.ascontiguousarray(both.T)).to(device)
    scores = test_logits(params, pairs, operands, cfg, aggregate, score)
    y = np.concatenate([np.ones(len(test_pos)), np.zeros(len(test_neg))])
    auc = roc_auc_score(y, scores.cpu().numpy())

    first_q = float(losses[: max(S // 4, 1)].mean())
    last_q = float(losses[-max(S // 4, 1):].mean())
    return {
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


def train_collab(cfg: ScaleGCNConfig = ScaleGCNConfig(), device=None,
                 verbose: bool = True) -> dict:
    """Train end-to-end on one card (`device`; default the visible card,
    and no card raises); returns losses, test AUC and throughput under the
    reference's keys."""
    if cfg.aggregation == "halo":
        raise NotImplementedError(
            "aggregation='halo' is the multi-device boundary-exchange path, "
            "ported with slice 6 (multi-GPU) of linkpred_tpu_torch")
    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} cards are visible: the node-sharded "
            "multi-card path is ported with slice 6 (multi-GPU) of "
            "linkpred_tpu_torch; make one card visible (CUDA_VISIBLE_DEVICES)")

    t0 = time.perf_counter()
    cfg, pairs_override = resolve_graph_source(cfg)
    problem = build_problem(cfg, pairs_override)
    operands = BucketedEll.from_graph(problem[0]).operands(device)
    build_seconds = time.perf_counter() - t0

    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed), device)
    out = train_and_score(cfg, problem, operands, params, device)
    out["build_seconds"] = round(build_seconds, 1)
    if verbose:
        print(f"collab-scale GCN: loss {out['loss_first_quarter']:.4f} -> "
              f"{out['loss_last_quarter']:.4f}, test AUC "
              f"{out['test_auc']:.4f}, {out['steps_per_s']} steps/s, "
              f"{out['agg_edges_per_s'] / 1e6:.0f}M agg-edges/s on "
              f"{device}")
    return out
