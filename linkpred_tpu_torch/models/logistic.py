"""L2-regularised logistic regression by Newton steps (IRLS) — the
counterpart of `linkpred_tpu/models/logistic.py`.

It stands for sklearn's `LogisticRegression(class_weight="balanced")`:
minimise C * sum_i w_i * logloss_i + 0.5 ||beta||^2 with the intercept
unpenalised; with `class_weight="balanced"` the sample weights are
n / (2 * n_class). Feature dims are ~100, so a dense Cholesky solve of the
(D+1) x (D+1) system converges in a handful of steps.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


@torch.no_grad()
def fit_logistic(x, y, class_weight: str | None = "balanced", c: float = 1.0,
                 num_iters: int = 16, *, device) -> torch.Tensor:
    """Fit on `x` [n, D], `y` [n] (tensors or arrays, moved to `device`) and
    return the coefficients [D+1] float32 on `device`, the intercept last.
    `num_iters` Newton steps from 0, f32, each one Cholesky solve."""
    x = _as_tensor(x, device)
    y = _as_tensor(y, device).reshape(-1)
    n, d = x.shape
    if class_weight == "balanced":
        n_pos = y.sum()
        sample_weight = torch.where(y == 1, n / (2 * n_pos),
                                    n / (2 * (n - n_pos)))
    else:
        sample_weight = torch.ones(n, device=x.device)
    xb = torch.cat([x, torch.ones((n, 1), device=x.device)], dim=1)
    beta = torch.zeros(d + 1, device=x.device)
    # penalty: 1/C on the weights, 0 on the intercept
    reg = torch.cat([torch.full((d,), 1.0 / c, device=x.device),
                     torch.zeros(1, device=x.device)])
    for _ in range(num_iters):
        p = torch.sigmoid(xb @ beta)
        w = sample_weight * p * (1 - p) + 1e-10
        grad = xb.T @ (sample_weight * (p - y)) + reg * beta
        h = (xb * w[:, None]).T @ xb + torch.diag(reg)
        delta = torch.cholesky_solve(grad[:, None],
                                     torch.linalg.cholesky(h))[:, 0]
        beta = beta - delta
    return beta


@torch.no_grad()
def predict_proba(beta: torch.Tensor, x) -> torch.Tensor:
    """P(link = 1 | x): [n] probabilities on `beta`'s device."""
    x = _as_tensor(x, beta.device)
    return torch.sigmoid(x @ beta[:-1] + beta[-1])
