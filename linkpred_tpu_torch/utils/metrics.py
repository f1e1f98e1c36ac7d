"""ROC metrics — the counterpart of `linkpred_tpu/utils/metrics.py`.

`roc_auc_score`, `roc_curve` and `accuracy` are host numpy, as in the
reference; `roc_auc` is the on-device AUC of the fused training loop (the
reference's `roc_auc_jax`), and `roc_auc_trials` its per-trial form for the
trial-major sweep.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve via the rank statistic (ties averaged);
    equal to sklearn's trapezoidal AUC for binary labels."""
    y_true = np.asarray(y_true).reshape(-1).astype(np.float64)
    y_score = np.asarray(y_score).reshape(-1).astype(np.float64)
    n_pos = float(y_true.sum())
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    ranks[order] = np.arange(1, len(y_score) + 1)
    sorted_scores = y_score[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while (j + 1 < len(sorted_scores)
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float((ranks[y_true == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def roc_curve(y_true: np.ndarray, y_score: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) at each distinct score, descending
    thresholds, with sklearn's (0, 0) origin prepended."""
    y_true = np.asarray(y_true).reshape(-1).astype(np.float64)
    y_score = np.asarray(y_score).reshape(-1).astype(np.float64)
    order = np.argsort(-y_score, kind="mergesort")
    y_true, y_score = y_true[order], y_score[order]
    distinct = np.where(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [len(y_true) - 1]])
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx - tps
    n_pos, n_neg = tps[-1], fps[-1]
    tpr = tps / max(n_pos, 1)
    fpr = fps / max(n_neg, 1)
    thresholds = y_score[idx]
    return (
        np.concatenate([[0.0], fpr]),
        np.concatenate([[0.0], tpr]),
        np.concatenate([[np.inf], thresholds]),
    )


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Share of predictions equal to the labels (host numpy)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float((y_true == y_pred).mean())


def roc_auc(y_true: torch.Tensor, y_score: torch.Tensor) -> torch.Tensor:
    """On-device AUC as a 0-d tensor (rank statistic). Tied scores take the
    lower rank in a stable sort — the exact AUC for continuous logits — as
    in the reference's `roc_auc_jax`."""
    y_true = y_true.reshape(-1).float()
    y_score = y_score.reshape(-1)
    order = torch.argsort(y_score, stable=True)
    ranks = torch.empty_like(y_score)
    ranks[order] = torch.arange(1, y_score.shape[0] + 1, dtype=y_score.dtype,
                                device=y_score.device)
    n_pos = y_true.sum()
    n_neg = y_true.shape[0] - n_pos
    pos_rank_sum = (ranks * y_true).sum()
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def roc_auc_trials(y_true: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """On-device AUC per trial column: `y_true` [V], `scores` [V, T] -> [T].
    Ranks by a double stable argsort along the sample axis, as the
    reference's `roc_auc_trials` (whose `jnp.argsort` is stable): tied
    scores rank in sample order."""
    y = y_true.reshape(-1, 1).float()
    order = torch.argsort(scores, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True) + 1
    n_pos = y.sum()
    n_neg = y.shape[0] - n_pos
    pos_rank_sum = (ranks.to(scores.dtype) * y).sum(dim=0)
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
