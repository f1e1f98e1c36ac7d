"""The ROC plot artifact (matplotlib, headless) — the counterpart of
`linkpred_tpu/utils/plots.py` (its comparison bar chart comes with the
`compare` subcommand).

matplotlib is imported inside the functions: a machine without it runs every
pipeline as long as no plot is asked for (the pipelines take the PNG path as
a parameter, `None` meaning no plot). Asking for a plot without matplotlib
raises `ImportError`.
"""

from __future__ import annotations

import os

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
