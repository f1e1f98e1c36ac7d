"""The numbers that decide `correct` for a training cell, each a reading of
the program's first three steps against the reference's from the same
inputs (see `PERF.md`, "How `correct` is decided"):

- `loss`: the largest relative gap between a step's loss and the
  reference's, over the three steps (and the trials); `loss1` the same
  over the first step alone;
- `grad`: the first gradient as the optimizer got it, by the worst leaf:
  the gap between the program's norm of a leaf and the reference's, over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger;
- `change`: the same for the parameters' change over the three steps, as
  step 4 gets them, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (their moves are round-off, e.g. a bias
  whose GraphNorm subtracts it again);
- `val_auc` (TwoWL): the largest gap of a val AUC;
- `best_at` (TwoWL): the best-val parameters' change from the start, the
  same way, against the reference's parameters after the epoch that the
  program's own val AUCs make best (the first largest, as a strict
  improvement keeps it). Both sides are read at one epoch, so two val AUCs
  that differ by less than their rounding cannot pick different epochs on
  the two sides; the select itself and the AUCs are still held;
- `build`: structural faults of the program's host build (an exact
  comparison, limit 0).

A trial-major leaf counts as one leaf per trial. numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

ROUND_OFF_LEAF = 1e-3  # of the median leaf's gradient norm


def split_trials(flat: list, axes: list | None) -> list:
    """Leaves as one tensor each, or, with the trial `axes` of trial-major
    leaves, one tensor per leaf and trial."""
    if axes is None:
        return [t.double() for t in flat]
    return [s.double() for t, ax in zip(flat, axes) for s in t.unbind(ax)]


def norms(flat: list) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t)) for t in flat])


def worst_leaf(prog: np.ndarray, ref: np.ndarray,
               keep: np.ndarray | None = None) -> float:
    """max over leaves of |prog - ref| / max(ref, the median of ref)."""
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    floor = max(float(np.median(ref)), np.finfo(np.float64).tiny)
    return float(np.max(np.abs(prog - ref) / np.maximum(ref, floor)))


def moved(ref_grad_norms: np.ndarray) -> np.ndarray:
    """Leaves whose reference gradient is not nought to rounding."""
    return ref_grad_norms >= ROUND_OFF_LEAF * np.median(ref_grad_norms)


def training_readings(prog: dict, ref: dict, axes: list | None) -> dict:
    """`prog` and `ref` hold `loss` (per step), `grad` (first gradient),
    `start` and `params` (leaves before step 1 and after step 3), as host
    tensors; `ref` may lack `start` (it is the program's). Returns the
    readings `loss`, `grad` and `change`."""
    lp = torch.stack([torch.as_tensor(x).double() for x in prog["loss"]])
    lr = torch.stack([torch.as_tensor(x).double() for x in ref["loss"]])
    gaps = (lp - lr).abs() / lr.abs()
    loss, loss1 = float(gaps.max()), float(gaps[0].max())
    gp, gr = norms(split_trials(prog["grad"], axes)), norms(
        split_trials(ref["grad"], axes))
    start = split_trials(prog["start"], axes)
    dp = norms([a - b for a, b in zip(split_trials(prog["params"], axes),
                                      start)])
    dr = norms([a - b for a, b in zip(split_trials(ref["params"], axes),
                                      start)])
    return {"loss": loss, "loss1": loss1, "grad": worst_leaf(gp, gr),
            "change": worst_leaf(dp, dr, moved(gr))}


def best_epochs(val_auc: list) -> np.ndarray:
    """The epoch whose parameters a strict-improvement select keeps: the
    first largest val AUC, per trial (epochs of [] or [T] -> [1] or [T])."""
    a = torch.stack([torch.as_tensor(x).double() for x in val_auc])
    return np.atleast_1d(np.argmax(a.numpy(), axis=0))


def twowl_readings(prog: dict, ref: dict, axes: list | None) -> dict:
    """`training_readings` plus `val_auc` and `best_at` (prog and ref also
    hold `val_auc` per epoch; prog the best-val parameters `best`, ref the
    parameters after each epoch, `by_epoch`)."""
    out = training_readings(prog, ref, axes)
    ap = torch.stack([torch.as_tensor(x).double() for x in prog["val_auc"]])
    ar = torch.stack([torch.as_tensor(x).double() for x in ref["val_auc"]])
    out["val_auc"] = float((ap - ar).abs().max())
    start = split_trials(prog["start"], axes)
    picks = best_epochs(prog["val_auc"])
    epochs = [split_trials(e, axes) for e in ref["by_epoch"]]
    # leaf i of the split lists belongs to trial i % T
    at = [epochs[picks[i % len(picks)]][i] for i in range(len(start))]
    gr = norms(split_trials(ref["grad"], axes))
    bp = norms([a - b for a, b in zip(split_trials(prog["best"], axes),
                                      start)])
    ba = norms([a - b for a, b in zip(at, start)])
    out["best_at"] = worst_leaf(bp, ba, moved(gr))
    return out


def judge(readings: dict, limits: dict) -> list:
    """[(name, value, limit)] for every number that has a limit; a reading
    without one is not compared (`PERF.md` names it)."""
    return [(k, float(readings[k]), float(limits[k])) for k in limits]
