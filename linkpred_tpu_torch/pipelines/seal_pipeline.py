"""Model family B: SEAL — enclosing-subgraph DGCNN link prediction, the
counterpart of `linkpred_tpu/pipelines/seal_pipeline.py`.

1. load fb-pages-food; negatives = shuffled non-edges cut to the number of
   positives,
2. node2vec embeddings on the train split with the train negatives injected
   as walkable edges (walks 10 x 80 on the device, SGNS dim 100, 1 epoch);
   nodes no walk visits get the mean row,
3. hop by the CN-vs-AA heuristic (or fixed),
4. vectorized enclosing-subgraph extraction on the host, DRNL tags on the
   device,
5. the compact stack (uint8 adjacency, tags, node ids, embedding table) on
   the device; the dense inputs of each minibatch are assembled there,
6. 90/10 shuffled split, minibatched DGCNN training (`models.seal`) and
   positive-class scoring,
7. test ROC-AUC, accuracy, the `AUC:x   Time:y` record, the checkpoint,
   optionally the ROC PNG.

The host steps draw from one `np.random.default_rng(cfg.seed)` in the JAX
package's order (permutation, negatives, extraction, split, schedule), so
pairs, subgraphs, tags, split and schedule are array-equal to its run. Walks,
SGNS, the init and dropout draw from torch generators: the AUC agrees within
the seed band, not digit for digit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from linkpred_tpu_torch.data import io, split as sp, subgraph as sg
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.models import seal
from linkpred_tpu_torch.models.word2vec import SGNSConfig, train_sgns_device
from linkpred_tpu_torch.ops.walk import WalkEngine
from linkpred_tpu_torch.utils import checkpoint, metrics, plots, records
from linkpred_tpu_torch.utils.timer import StepTimer


@dataclasses.dataclass(frozen=True)
class SEALConfig:
    test_ratio: float = 0.1
    dimension: int = 100  # node2vec embedding size
    hop: str | int = "auto"
    max_neighbors: int = 100
    top_k_percent: float = 60.0
    learning_rate: float = 1e-4
    epochs: int = 50
    batch_size: int = 32
    negative_injection: bool = True
    seed: int = 0
    dataset: str = "fb-pages-food"
    records_dir: str = records.DEFAULT_RECORDS_DIR


def learn_embedding(train_pos: np.ndarray, train_neg: np.ndarray,
                    num_nodes: int, cfg: SEALConfig, *,
                    device) -> torch.Tensor:
    """node2vec + SGNS on the train graph, the train negatives injected as
    walkable edges; rows of nodes that no walk visits (isolated in the walk
    graph) get the mean of the visited rows. [num_nodes, dimension] f32 on
    `device`; walks and SGNS draw from generators seeded `cfg.seed` and
    `cfg.seed + 1`."""
    pairs = (np.concatenate([train_pos, train_neg], axis=0)
             if cfg.negative_injection else train_pos)
    g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1],
                                    num_nodes=num_nodes)
    walks = WalkEngine(g, p=1.0, q=1.0, device=device).walks(
        torch.Generator(device=device).manual_seed(cfg.seed),
        num_walks=10, walk_length=80)
    emb = train_sgns_device(
        torch.Generator(device=device).manual_seed(cfg.seed + 1), walks,
        num_nodes,
        SGNSConfig(dim=cfg.dimension, window=10, negatives=5, epochs=1))
    visited = torch.zeros(num_nodes, dtype=torch.bool, device=walks.device)
    visited[walks.reshape(-1).long()] = True
    visited &= torch.as_tensor(g.degree > 0, device=walks.device)
    if bool(visited.any()) and bool((~visited).any()):
        emb[~visited] = emb[visited].mean(dim=0)
    return emb


def restore_seal_params(feature_dim: int, threshold_k: int,
                        path: str | None = None, *,
                        device=None) -> seal.DGCNNParams:
    """DGCNN parameters from a checkpoint of either package on `device`
    (None: the card, `cuda_device()`, which raises when none is visible);
    by default the latest `checkpoints/seal/model-<step>.npz`."""
    path = path or checkpoint.latest_checkpoint("checkpoints/seal", "model")
    if path is None:
        raise FileNotFoundError("no SEAL checkpoint under checkpoints/seal/")
    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    like = seal.init_params(torch.Generator().manual_seed(0), feature_dim,
                            threshold_k, device)
    return checkpoint.restore_pytree(path, like)


class SEALData(NamedTuple):
    """The host side of a run: subgraphs of `pairs` (negatives, then
    positives) with `labels`, the hop, the train/test split `tr`/`te`, the
    schedule `batch_idx` [epochs * steps, batch] and the embedding table on
    the device."""
    pairs: np.ndarray
    labels: np.ndarray
    hop: int
    batch: sg.SubgraphBatch
    tr: np.ndarray
    te: np.ndarray
    batch_idx: np.ndarray
    emb: torch.Tensor


def prepare(cfg: SEALConfig, data_dir: Optional[str], *, device,
            timer: StepTimer) -> SEALData:
    """Steps 1-4 and the split and schedule, timed in `timer`'s spans; the
    numpy draws in the JAX package's order."""
    rng = np.random.default_rng(cfg.seed)
    with timer.span("load+negatives"):
        g, edges = io.load_fb_pages_food(data_dir)
        positive = sp._dedup_upper(edges)
        positive = positive[rng.permutation(len(positive))]
        negative = sp.shuffled_non_edges(positive, g.num_nodes,
                                         num_samples=len(positive), rng=rng)
        test_size = int(len(positive) * cfg.test_ratio)
        train_pos, test_pos = positive[:-test_size], positive[-test_size:]
        train_neg, test_neg = negative[:-test_size], negative[-test_size:]

    with timer.span("embedding"):
        emb = learn_embedding(train_pos, train_neg, g.num_nodes, cfg,
                              device=device)

    with timer.span("subgraphs+drnl"):
        adj = np.zeros((g.num_nodes, g.num_nodes), dtype=bool)
        adj[train_pos[:, 0], train_pos[:, 1]] = True
        adj[train_pos[:, 1], train_pos[:, 0]] = True
        hop = (sg.auto_hop(adj, test_pos, test_neg) if cfg.hop == "auto"
               else int(cfg.hop))
        # negatives (label 0), then positives (label 1), as the reference
        pairs = np.concatenate([negative, positive], axis=0)
        labels = np.concatenate([np.zeros(len(negative), np.int32),
                                 np.ones(len(positive), np.int32)])
        batch = sg.build_subgraph_batch(pairs, adj, hop,
                                        max_neighbors=cfg.max_neighbors,
                                        rng=rng, device=device)

    perm = rng.permutation(len(labels))
    n_train = int(len(labels) * 0.9)
    tr, te = perm[:n_train], perm[n_train:]
    batch_idx = seal.batch_schedule(rng, tr, cfg.batch_size, cfg.epochs)
    return SEALData(pairs, labels, hop, batch, tr, te, batch_idx, emb)


def run_seal(cfg: SEALConfig = SEALConfig(), data_dir: Optional[str] = None,
             *, device=None, verbose: bool = True,
             roc_png: Optional[str] = None,
             metrics_file: str = "logs/metrics.jsonl",
             checkpoint_prefix: Optional[str] = "checkpoints/seal/model"
             ) -> dict:
    """Run the family end to end on `device` (default the visible card; no
    card raises). Writes the record under `cfg.records_dir`, the parameters
    to `<checkpoint_prefix>-1000.npz` (None: no checkpoint), a summary line
    to `metrics_file` and, when `roc_png` is a path, the ROC plot
    (matplotlib is then needed, and its absence raises before any work).
    Returns the JAX package's keys; `compile_seconds` is 0.0 (nothing
    compiles) and `train_seconds` covers the training steps after two
    untimed ones on a throwaway copy of the parameters."""
    if roc_png is not None:
        plots.require_matplotlib()
    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    timer = StepTimer()
    data = prepare(cfg, data_dir, device=device, timer=timer)
    batch, labels, te = data.batch, data.labels, data.te

    with timer.span("gnn inputs"):
        threshold_k = seal.threshold_from_sizes(batch.sizes,
                                                cfg.top_k_percent)
        feature_dim = batch.tags_size + data.emb.shape[1]
        stack = seal.CompactStack.from_batch(batch, data.emb, labels, device)
        batch_idx = torch.as_tensor(data.batch_idx, device=device)

    init_seed, drop_seed = seal.seeds(cfg.seed)
    params = seal.init_params(torch.Generator().manual_seed(init_seed),
                              feature_dim, threshold_k, device)
    optimizer = seal.adam(params, cfg.learning_rate)
    with timer.span("compile(warm-up)"):
        # the reference's span name; nothing compiles here
        seal.warm_up(params, cfg.learning_rate, batch_idx[:2], stack,
                     threshold_k, seal.DROPOUT_RATE)

    t_train0 = time.perf_counter()
    with timer.span("train"):
        losses = seal.train_steps(
            params, optimizer, batch_idx, stack, threshold_k,
            seal.DROPOUT_RATE,
            torch.Generator(device=device).manual_seed(drop_seed))
        losses = losses.cpu().numpy()  # the host read closes the span
    train_seconds = time.perf_counter() - t_train0
    if verbose:
        per_epoch = losses.reshape(cfg.epochs, -1).mean(axis=1)
        print(f"loss: first epoch {per_epoch[0]:.4f}, last "
              f"{per_epoch[-1]:.4f}")

    with timer.span("predict"):
        te_d = torch.as_tensor(te, device=device)
        scores = seal.predict_scores_compact(
            params, stack.adj[te_d], stack.tags[te_d], stack.nodes[te_d],
            stack.node_mask[te_d], stack.emb, batch.tags_size,
            threshold_k).cpu().numpy()
        auc = metrics.roc_auc_score(labels[te], scores)
        acc = metrics.accuracy(labels[te], (scores > 0.5).astype(np.int32))

    records.write_record(cfg.dataset, "seal", auc, train_seconds,
                         cfg.records_dir, append=False)
    if checkpoint_prefix is not None:
        checkpoint.save_pytree(checkpoint_prefix, params, step=1000)
    if roc_png is not None:
        fpr, tpr, _ = metrics.roc_curve(labels[te], scores)
        plots.plot_roc(fpr, tpr, auc, "SEAL DGCNN ROC", roc_png)
    records.MetricsLogger(metrics_file).log(
        family="seal", auc=float(auc), accuracy=float(acc), hop=int(data.hop),
        threshold_k=int(threshold_k), train_seconds=train_seconds,
        compile_seconds=0.0, total_seconds=timer.total)
    if verbose:
        print(timer.report())
        print(f"seal: hop={data.hop} threshold_k={threshold_k} test AUC "
              f"{auc:.4f} acc {acc:.4f} (reference 0.8661)")
    return {
        "auc": auc,
        "accuracy": acc,
        "hop": data.hop,
        "threshold_k": threshold_k,
        "train_seconds": train_seconds,
        "compile_seconds": 0.0,
        "total_seconds": timer.total,
        "params": params,
    }
