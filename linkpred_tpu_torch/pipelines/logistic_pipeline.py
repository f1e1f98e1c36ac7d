"""Model family A: node2vec embeddings + logistic regression — the
counterpart of `linkpred_tpu/pipelines/logistic_pipeline.py`.

1. load the fb-pages-food graph,
2. negatives = the reference's scan of unconnected pairs (or the pairs
   within 2 hops),
3. positives = edges removable without disconnecting the graph,
4. biased random walks on the residual graph (p = q = 1, 50 walks x length
   16) by the walk engine on the device,
5. SGNS embeddings (dim 100, window 10, 5 negatives, 5 epochs) trained on
   the device from the walk matrix where it lies,
6. pair features = sum of endpoint embeddings (`ops.sddmm.edge_sum`),
7. 70/30 split + balanced L2 logistic regression (Newton steps),
8. test ROC-AUC, the `AUC:x   Time:y` record, optionally the ROC PNG.

The host steps (1-3, the split) use the same numpy streams as the JAX
package; walks and SGNS draw from torch generators seeded `cfg.seed` and
`cfg.seed + 1`, so the AUC agrees within the seed band, not digit for digit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from linkpred_tpu_torch.data import io, split as sp
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.models.logistic import fit_logistic, predict_proba
from linkpred_tpu_torch.models.word2vec import SGNSConfig, train_sgns_device
from linkpred_tpu_torch.ops.sddmm import edge_sum
from linkpred_tpu_torch.ops.walk import WalkEngine
from linkpred_tpu_torch.utils import metrics, plots, records
from linkpred_tpu_torch.utils.timer import StepTimer


@dataclasses.dataclass(frozen=True)
class LogisticConfig:
    num_walks: int = 50
    walk_length: int = 16
    p: float = 1.0
    q: float = 1.0
    embed: SGNSConfig = SGNSConfig(dim=100, window=10, negatives=5, epochs=5)
    test_ratio: float = 0.3
    seed: int = 35  # the reference's train_test_split random_state
    # "reference": the reference's negative scan, replayed as it is (easy
    # negatives; the pool its published 0.8075 AUC is measured on).
    # "two_hop": negatives within 2 hops only, a harder task (AUC ~0.75).
    negatives: str = "reference"
    dataset: str = "fb-pages-food"
    records_dir: str = records.DEFAULT_RECORDS_DIR


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_logistic(cfg: LogisticConfig = LogisticConfig(),
                 data_dir: Optional[str] = None, *, device,
                 verbose: bool = True, roc_png: Optional[str] = None,
                 metrics_file: str = "logs/metrics.jsonl") -> dict:
    """Run the family end to end on `device`. Writes the record file under
    `cfg.records_dir`, a summary line to `metrics_file` and, when `roc_png`
    is a path, the ROC plot (matplotlib is then needed, and its absence
    raises before any work is done). Returns the reference's keys."""
    if roc_png is not None:
        plots.require_matplotlib()
    device = torch.device(device)
    timer = StepTimer()
    rng = np.random.default_rng(cfg.seed)

    with timer.span("load"):
        g, edges = io.load_fb_pages_food(data_dir)

    with timer.span("negatives"):
        neg_pairs = (
            sp.reference_scan_negatives(edges, g.num_nodes)
            if cfg.negatives == "reference"
            else sp.two_hop_negatives(edges, g.num_nodes)
        )

    with timer.span("positives(removable)"):
        removable = sp.removable_positive_edges(edges, g.num_nodes)
        pos_pairs = edges[removable]
        keep_idx = np.setdiff1d(np.arange(len(edges)), removable)
        residual = Graph.from_undirected_edges(
            edges[keep_idx, 0], edges[keep_idx, 1], num_nodes=g.num_nodes
        )

    with timer.span("walks"):
        eng = WalkEngine(residual, p=cfg.p, q=cfg.q, device=device)
        walks = eng.walks(
            torch.Generator(device=device).manual_seed(cfg.seed),
            cfg.num_walks, cfg.walk_length)
        _sync(device)

    with timer.span("sgns"):
        emb = train_sgns_device(
            torch.Generator(device=device).manual_seed(cfg.seed + 1), walks,
            g.num_nodes, cfg.embed)
        _sync(device)

    with timer.span("features"):
        pairs = np.concatenate([pos_pairs, neg_pairs], axis=0)
        y = np.concatenate(
            [np.ones(len(pos_pairs)), np.zeros(len(neg_pairs))]
        )
        pairs_d = torch.as_tensor(pairs, dtype=torch.long, device=device)
        x = edge_sum(pairs_d[:, 0], pairs_d[:, 1], emb)
        train_idx, test_idx = sp.train_test_split_arrays(
            len(y), cfg.test_ratio, rng
        )
        x_train = x[torch.as_tensor(train_idx, device=device)]
        x_test = x[torch.as_tensor(test_idx, device=device)]
        y_train = torch.as_tensor(y[train_idx], dtype=torch.float32,
                                  device=device)
        _sync(device)

    with timer.span("compile(warm-up)"):
        # the reference's span name; nothing compiles here. One untimed fit
        # and predict at the real shapes, on zeros: the first Cholesky
        # solve of a process sets the solver library up, and `fit_seconds`
        # below is to be the cost of a warm fit
        predict_proba(fit_logistic(torch.zeros_like(x_train), y_train,
                                   class_weight="balanced", device=device),
                      torch.zeros_like(x_test))
        _sync(device)

    t_fit0 = time.perf_counter()
    with timer.span("fit+predict"):
        beta = fit_logistic(x_train, y_train, class_weight="balanced",
                            device=device)
        scores = predict_proba(beta, x_test).cpu().numpy()
    fit_seconds = time.perf_counter() - t_fit0

    auc = metrics.roc_auc_score(y[test_idx], scores)
    fpr, tpr, _ = metrics.roc_curve(y[test_idx], scores)
    records.write_record(
        cfg.dataset, "logistic", auc, fit_seconds, cfg.records_dir, append=False
    )
    if roc_png is not None:
        plots.plot_roc(fpr, tpr, auc, "node2vec + Logistic Regression ROC",
                       roc_png)
    records.MetricsLogger(metrics_file).log(
        family="logistic", auc=float(auc), fit_seconds=fit_seconds,
        total_seconds=timer.total, num_pos=len(pos_pairs),
        num_neg=len(neg_pairs),
    )
    if verbose:
        print(timer.report())
        print(
            f"logistic: {len(pos_pairs)} pos / {len(neg_pairs)} neg pairs, "
            f"test AUC {auc:.4f} (reference 0.8075)"
        )
    return {
        "auc": auc,
        "fit_seconds": fit_seconds,
        "total_seconds": timer.total,
        "fpr": fpr,
        "tpr": tpr,
        "num_pos": len(pos_pairs),
        "num_neg": len(neg_pairs),
    }
