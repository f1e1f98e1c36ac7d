"""SEAL at ogbl-collab scale — the counterpart of
`linkpred_tpu/pipelines/seal_scale.py`.

A dense [N, N] adjacency cannot exist at 235k nodes, so:

- the targets are a sample of the edges plus as many uniformly sampled
  non-edges,
- the message graph is every edge but the held-out test positives (a train
  positive's own link stays in the graph and is masked in its subgraph),
- extraction and DRNL run over CSR in the threaded C++ plane
  (`data.subgraph.build_subgraph_batch_csr`: O(P·K²) memory),
- training and scoring are the batched DGCNN of the small pipeline
  (`models.seal.train_steps` over a `CompactStack` on the device).

Features are one-hot DRNL tags; `use_embedding` adds node2vec rows (walks
and SGNS on the device).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from linkpred_tpu_torch.data import subgraph as sg
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.data.split import negative_sampling
from linkpred_tpu_torch.data.synth import synth_powerlaw_graph
from linkpred_tpu_torch.models import seal
from linkpred_tpu_torch.models.word2vec import SGNSConfig, train_sgns_device
from linkpred_tpu_torch.ops.walk import WalkEngine
from linkpred_tpu_torch.pipelines.gcn_scale import resolve_graph_source
from linkpred_tpu_torch.utils import metrics


@dataclasses.dataclass(frozen=True)
class ScaleSEALConfig:
    nodes: int = 235_000
    edges: int = 1_200_000
    target_pairs: int = 4096  # positives sampled as targets (same # negs)
    test_fraction: float = 0.1
    hop: int = 2
    max_neighbors: int = 100
    top_k_percent: float = 60.0
    learning_rate: float = 1e-4
    epochs: int = 10
    batch_size: int = 64
    use_embedding: bool = False
    emb_dim: int = 64
    seed: int = 0
    # a real edge dump instead of the synthetic generator
    edges_file: str | None = None


def build_problem(cfg: ScaleSEALConfig, pairs_override=None):
    """The graph (synthetic power-law or the given `(lo, hi)` pairs), the
    sampled targets and the message graph, array-equal to the JAX
    package's: `(graph, (train_pos, train_neg, test_pos, test_neg))`."""
    rng = np.random.default_rng(cfg.seed)
    if pairs_override is not None:
        lo, hi = pairs_override
    else:
        lo, hi = synth_powerlaw_graph(cfg.nodes, cfg.edges, alpha=0.9,
                                      seed=cfg.seed)
    pairs = np.stack([lo, hi], axis=1)

    perm = rng.permutation(len(pairs))
    pos_idx = perm[: cfg.target_pairs]
    positives = pairs[pos_idx]
    negatives = negative_sampling(pairs, cfg.nodes, cfg.target_pairs, rng=rng)

    n_test = int(cfg.target_pairs * cfg.test_fraction)
    test_pos, train_pos = positives[:n_test], positives[n_test:]
    test_neg, train_neg = negatives[:n_test], negatives[n_test:]

    # the message graph: every edge but the held-out test positives
    keep = np.ones(len(pairs), dtype=bool)
    keep[pos_idx[:n_test]] = False
    msg = pairs[keep]
    g = Graph.from_undirected_edges(msg[:, 0], msg[:, 1], num_nodes=cfg.nodes)
    return g, (train_pos, train_neg, test_pos, test_neg)


def run_seal_scale(cfg: ScaleSEALConfig = ScaleSEALConfig(), *, device=None,
                   verbose: bool = True) -> dict:
    """Build, extract, train and score on `device` (default the visible
    card; no card raises). Returns the JAX package's result keys;
    `compile_seconds` is 0.0 (nothing compiles) and `train_seconds` covers
    the steps after two untimed ones on a throwaway copy of the
    parameters."""
    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)

    t0 = time.perf_counter()
    cfg, pairs_override = resolve_graph_source(cfg)
    g, (train_pos, train_neg, test_pos, test_neg) = build_problem(
        cfg, pairs_override)
    build_seconds = time.perf_counter() - t0

    all_pairs = np.concatenate([train_pos, train_neg, test_pos, test_neg])
    labels = np.concatenate([
        np.ones(len(train_pos), np.int32), np.zeros(len(train_neg), np.int32),
        np.ones(len(test_pos), np.int32), np.zeros(len(test_neg), np.int32),
    ])
    n_train = len(train_pos) + len(train_neg)
    te = np.arange(n_train, len(all_pairs))

    t0 = time.perf_counter()
    batch = sg.build_subgraph_batch_csr(
        all_pairs, np.asarray(g.indptr), np.asarray(g.indices), cfg.nodes,
        cfg.hop, cfg.max_neighbors, seed=cfg.seed, device=device)
    extract_seconds = time.perf_counter() - t0
    subgraphs_per_s = len(all_pairs) / extract_seconds

    emb = None
    if cfg.use_embedding:
        walks = WalkEngine(g, p=1.0, q=1.0, device=device).walks(
            torch.Generator(device=device).manual_seed(cfg.seed),
            num_walks=2, walk_length=40)
        emb = train_sgns_device(
            torch.Generator(device=device).manual_seed(cfg.seed + 1), walks,
            cfg.nodes,
            SGNSConfig(dim=cfg.emb_dim, window=10, negatives=5, epochs=1))

    threshold_k = seal.threshold_from_sizes(batch.sizes, cfg.top_k_percent)
    feature_dim = batch.tags_size + (emb.shape[1] if emb is not None else 0)
    stack = seal.CompactStack.from_batch(batch, emb, labels, device)
    batch_idx = torch.as_tensor(seal.batch_schedule(
        np.random.default_rng(cfg.seed + 2), np.arange(n_train),
        cfg.batch_size, cfg.epochs), device=device)

    init_seed, drop_seed = seal.seeds(cfg.seed)
    params = seal.init_params(torch.Generator().manual_seed(init_seed),
                              feature_dim, threshold_k, device)
    optimizer = seal.adam(params, cfg.learning_rate)
    seal.warm_up(params, cfg.learning_rate, batch_idx[:2], stack,
                 threshold_k, seal.DROPOUT_RATE)

    t0 = time.perf_counter()
    losses = seal.train_steps(
        params, optimizer, batch_idx, stack, threshold_k, seal.DROPOUT_RATE,
        torch.Generator(device=device).manual_seed(drop_seed))
    losses = losses.cpu().numpy()  # the host read closes the timed span
    train_seconds = time.perf_counter() - t0

    te_d = torch.as_tensor(te, device=device)
    scores = seal.predict_scores_compact(
        params, stack.adj[te_d], stack.tags[te_d], stack.nodes[te_d],
        stack.node_mask[te_d], stack.emb, batch.tags_size,
        threshold_k).cpu().numpy()
    auc = metrics.roc_auc_score(labels[te], scores)

    q = max(len(losses) // 4, 1)
    first_q, last_q = float(losses[:q].mean()), float(losses[-q:].mean())
    out = {
        "nodes": cfg.nodes,
        "directed_edges": int(g.num_edges),
        "hop": cfg.hop,
        "target_pairs": int(len(all_pairs)),
        "subgraphs_per_s": round(subgraphs_per_s),
        "extract_seconds": round(extract_seconds, 2),
        "mean_subgraph_size": round(float(batch.sizes.mean()), 1),
        "tags_size": int(batch.tags_size),
        "loss_first_quarter": first_q,
        "loss_last_quarter": last_q,
        "loss_decreased": bool(last_q < first_q),
        "test_auc": float(auc),
        "train_seconds": round(train_seconds, 2),
        "compile_seconds": 0.0,
        "build_seconds": round(build_seconds, 1),
        "use_embedding": cfg.use_embedding,
    }
    if verbose:
        print(f"collab-scale SEAL: {out['subgraphs_per_s']} subgraphs/s "
              f"(hop {cfg.hop}), loss {first_q:.4f} -> {last_q:.4f}, "
              f"test AUC {auc:.4f} on {device}")
    return out
