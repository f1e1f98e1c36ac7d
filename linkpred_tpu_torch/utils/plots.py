"""The ROC plot and the family comparison chart (matplotlib, headless) —
the counterpart of `linkpred_tpu/utils/plots.py`.

matplotlib is imported inside the functions: a machine without it runs every
pipeline as long as no plot is asked for (the pipelines take the PNG path as
a parameter, `None` meaning no plot). Asking for a plot without matplotlib
raises `ImportError`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def require_matplotlib() -> None:
    """Raise `ImportError` now if a later plot would: a pipeline that was
    asked for a plot calls this before it starts its work."""
    _plt()


def plot_roc(fpr: np.ndarray, tpr: np.ndarray, auc: float, title: str,
             out_path: str) -> str:
    plt = _plt()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(fpr, tpr, label=f"AUC = {auc:.4f}")
    ax.plot([0, 1], [0, 1], linestyle="--", linewidth=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title(title)
    ax.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_family_comparison(families: Sequence[str],
                           aucs: Sequence[Optional[float]], out_path: str,
                           title: str = "Best test ROC-AUC per model family",
                           times: Sequence[Optional[float]] | None = None
                           ) -> str:
    """AUC bar chart of the families, each bar labelled with its AUC and,
    where `times` has one, its recorded wall time."""
    plt = _plt()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 4))
    xs = np.arange(len(families))
    vals = [a if a is not None else 0.0 for a in aucs]
    ax.bar(xs, vals)
    for i, (x, v) in enumerate(zip(xs, vals)):
        label = f"{v:.4f}"
        if times is not None and times[i] is not None:
            label += f"\n{times[i]:.2f}s"
        ax.text(x, v + 0.005, label, ha="center", fontsize=9)
    ax.set_xticks(xs)
    ax.set_xticklabels(families)
    ax.set_ylim(0, 1.1)
    ax.set_ylabel("ROC-AUC")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
