"""Model family C, TwoWL: training routine and hyperparameter search — the
counterpart of `linkpred_tpu/pipelines/twowl_pipeline.py`.

1. load fb-pages-food and build the 85/5/10 split with doubled edges and
   ei2 edge-pair structures (the port's host module `data.twowl`),
2. per epoch: one val-sized minibatch of positive + negative pairs, the
   positives masked out of the message graph, Adam, val AUC on the device,
3. early stop, best-val params, test AUC, and the reference-format outputs
   (`AUC:x   Time:y` record, `fpr.json`/`tpr.json`, `logs.json`),
4. a seeded random search over the reference's hyperparameter space,
5. optionally a trial-major refine of the winner's architecture: T
   (lr x dropout) trials trained at once (`refine_vmapped`), by successive
   halving (`refine_halving`) or in rounds sampled from the best configs
   seen (`refine_adaptive`).

The batch schedules and the refine draws come from the same numpy streams
as in the JAX package (`np.random.default_rng(run.seed)`, and `run.seed +
17` for a refine), so both see the same batches and sample the same
configurations. `train_routine` is the unfused per-epoch host loop;
`run_twowl` also writes the best parameters as a checkpoint and, when given
a path, the ROC plot.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from linkpred_tpu_torch.data import io
from linkpred_tpu_torch.data.twowl import (TwoWLData, TwoWLSplit,
                                           build_twowl_data)
from linkpred_tpu_torch.models import twowl as m
from linkpred_tpu_torch.utils import checkpoint, metrics, plots, records
from linkpred_tpu_torch.utils.progress import LiveProgress
from linkpred_tpu_torch.utils.timer import StepTimer


@dataclasses.dataclass(frozen=True)
class TwoWLRunConfig:
    epochs: int = 1000
    early_stop: int = 800
    seed: int = 0
    dataset: str = "fb-pages-food"
    records_dir: str = records.DEFAULT_RECORDS_DIR
    val_ratio: float = 0.05
    test_ratio: float = 0.1


def load_edges(data_dir: Optional[str] = None) -> tuple[np.ndarray, int]:
    """fb-pages-food's undirected edge list and its node count."""
    _, edges = io.load_fb_pages_food(data_dir)
    return edges, int(edges.max()) + 1


def build_data(edges: np.ndarray, num_nodes: int, run: TwoWLRunConfig,
               rng: np.random.Generator) -> TwoWLData:
    """The three splits with doubled edges and ei2 structures, on the host."""
    return build_twowl_data(edges, num_nodes, rng=rng,
                            val_ratio=run.val_ratio, test_ratio=run.test_ratio)


def node_features(cfg: m.TwoWLConfig, data: TwoWLData, device) -> torch.Tensor:
    if cfg.degree_feature:
        return torch.as_tensor(data.node_deg, dtype=torch.long, device=device)
    return torch.arange(data.num_nodes, device=device)


def evaluate(params: dict, cfg: m.TwoWLConfig, data: TwoWLData,
             s: TwoWLSplit, device) -> tuple[float, np.ndarray]:
    scores = m.eval_scores(
        params, node_features(cfg, data, device),
        m.SplitArrays.from_split(s, device), cfg).cpu().numpy()
    return metrics.roc_auc_score(s.y, scores), scores


def batch_schedule(data: TwoWLData, run: TwoWLRunConfig,
                   rng: np.random.Generator | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Per-epoch sampled train pair ids, `[E, P]` int32 each (positives,
    negatives), drawn exactly as the reference draws them: one val-sized
    minibatch per epoch, half positives, half negatives, from `rng`
    (default `np.random.default_rng(run.seed)`)."""
    n_pos_pairs = data.train.num_msg // 2
    n_neg_pairs = len(data.train.pred) // 2
    P = min(len(data.val.y), n_pos_pairs, n_neg_pairs)
    rng = np.random.default_rng(run.seed) if rng is None else rng
    E = run.epochs
    pos_ids = np.stack(
        [rng.permutation(n_pos_pairs)[:P] for _ in range(E)]).astype(np.int32)
    neg_ids = np.stack(
        [rng.permutation(n_neg_pairs)[:P] for _ in range(E)]).astype(np.int32)
    return pos_ids, neg_ids


def _seeded_start(cfg: m.TwoWLConfig, seed: int, device,
                  params: dict | None) -> tuple:
    """(parameters, dropout generator, optimizer) of a single-trial run:
    `np.random.SeedSequence(seed)` draws the init on the host, unless
    `params` replaces it, and the dropout masks on `device`."""
    init_seed, drop_seed = np.random.SeedSequence(seed).generate_state(2)
    if params is None:
        params = m.init_params(
            cfg, torch.Generator().manual_seed(int(init_seed)), device)
    generator = torch.Generator(device=device).manual_seed(int(drop_seed))
    return params, generator, m.adam(params, cfg.learning_rate)


def train_routine(data: TwoWLData, cfg: m.TwoWLConfig, run: TwoWLRunConfig,
                  device, seed: int | None = None, verbose: bool = False,
                  params: dict | None = None,
                  schedule: tuple | None = None) -> dict:
    """Early-stopped training as a per-epoch host loop: a train step, the
    val split scored and its AUC read on the host, and on every new best
    the test split scored and timed. The unfused counterpart of
    `train_routine_fused`; it returns the parameters of the last epoch
    run, as the reference's does, and the per-epoch val AUC and loss.

    Each epoch draws its positives, then its negatives, from
    `np.random.default_rng(run.seed)` (the reference's order, which differs
    from the fused loop's `batch_schedule`); `schedule`, a `(pos_ids,
    neg_ids)` pair of `[E, P]` arrays, replaces the draws. `seed` and
    `params` as in `train_routine_fused`."""
    params, generator, optimizer = _seeded_start(
        cfg, run.seed if seed is None else seed, device, params)
    trn = m.SplitArrays.from_split(data.train, device)
    n_pos_pairs = data.train.num_msg // 2
    n_neg_pairs = len(data.train.pred) // 2
    P = min(len(data.val.y), n_pos_pairs, n_neg_pairs)

    def ids(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)

    rng = np.random.default_rng(run.seed)
    best_val, tst_score, since_best, t_eval = 0.0, 0.0, 0, 0.0
    best_roc = (None, None)
    evaluate(params, cfg, data, data.test, device)  # warm the timed eval
    progress = LiveProgress(run.epochs, label="twowl") if verbose else None
    history, loss_history = [], []
    for epoch in range(run.epochs):
        if schedule is None:
            pos_ids = rng.permutation(n_pos_pairs)[:P]
            neg_ids = rng.permutation(n_neg_pairs)[:P]
        else:
            pos_ids, neg_ids = schedule[0][epoch], schedule[1][epoch]
        loss, _, _ = m.train_step(params, optimizer, generator, ids(pos_ids),
                                  ids(neg_ids), trn, cfg, data.num_nodes)
        val_auc, _ = evaluate(params, cfg, data, data.val, device)
        history.append(val_auc)
        loss_history.append(float(loss))
        if progress is not None:
            progress.update(epoch + 1, loss=loss_history[-1], auc=val_auc)
        since_best += 1
        if val_auc > best_val:
            best_val, since_best = val_auc, 0
            t0 = time.perf_counter()
            tst_score, tst_scores = evaluate(params, cfg, data, data.test,
                                             device)
            t_eval = time.perf_counter() - t0
            best_roc = metrics.roc_curve(data.test.y, tst_scores)[:2]
            if verbose:
                print(f"epoch {epoch:04d} loss {loss_history[-1]:.4f} "
                      f"val {val_auc:.4f} tst {tst_score:.4f}")
        if since_best > run.early_stop:
            break
    if progress is not None:
        progress.close()
    return {
        "best_val": best_val,
        "test_auc": tst_score,
        "test_eval_seconds": t_eval,
        "fpr": best_roc[0],
        "tpr": best_roc[1],
        "params": m.tree_map(lambda p: p.detach(), params),
        "history": np.asarray(history, np.float32),
        "loss_history": np.asarray(loss_history, np.float32),
    }


def train_routine_fused(data: TwoWLData, cfg: m.TwoWLConfig,
                        run: TwoWLRunConfig, device, seed: int | None = None,
                        verbose: bool = False, params: dict | None = None
                        ) -> dict:
    """Early-stopped training as one on-device epoch loop
    (`models.twowl.train_loop`), then the test split scored once with the
    best-val parameters (eval warmed before timing, so the recorded Time is
    a warm eval).

    `seed` (default `run.seed`) draws the init on the host and the dropout
    masks on `device`; `params` replaces the drawn init (the tests pass the
    JAX package's init). Returns best val AUC, test AUC and ROC, the best
    params, the per-epoch val AUC (`history`) and loss (`loss_history`),
    and the train loop's epochs and seconds.
    """
    params, generator, optimizer = _seeded_start(
        cfg, run.seed if seed is None else seed, device, params)

    trn = m.SplitArrays.from_split(data.train, device)
    val = m.SplitArrays.from_split(data.val, device)
    pos_ids, neg_ids = (torch.as_tensor(a, dtype=torch.long, device=device)
                        for a in batch_schedule(data, run))
    val_y = torch.as_tensor(data.val.y, device=device)

    t0 = time.perf_counter()
    best_params, best_auc, since, (losses, aucs) = m.train_loop(
        params, optimizer, generator, pos_ids, neg_ids, trn, val, val_y,
        node_features(cfg, data, device), cfg, data.num_nodes,
        early_stop=run.early_stop,
    )
    best_val = float(best_auc)  # waits for the loop's last kernels
    train_seconds = time.perf_counter() - t0
    losses, aucs = losses.cpu().numpy(), aucs.cpu().numpy()
    since = int(since)
    epochs_run = run.epochs
    if since > run.early_stop:
        epochs_run = run.epochs - (since - run.early_stop - 1)
    if verbose:
        ran = losses[:epochs_run]
        print(f"  epochs 0-{epochs_run} loss {float(ran.mean()):.4f} "
              f"val {float(aucs[epochs_run - 1]):.4f} best {best_val:.4f}",
              flush=True)
        if epochs_run < run.epochs:
            print(f"  early stop at epoch {epochs_run} (no val improvement "
                  f"in > {run.early_stop} epochs)", flush=True)

    evaluate(best_params, cfg, data, data.test, device)  # warm the eval
    t0 = time.perf_counter()
    tst_score, tst_scores = evaluate(best_params, cfg, data, data.test, device)
    t_eval = time.perf_counter() - t0
    fpr, tpr, _ = metrics.roc_curve(data.test.y, tst_scores)
    if verbose:
        print(f"fused: best val {best_val:.4f} test {tst_score:.4f}")
    return {
        "best_val": best_val,
        "test_auc": tst_score,
        "test_eval_seconds": t_eval,
        "fpr": fpr,
        "tpr": tpr,
        "params": best_params,
        "history": aucs,
        "loss_history": losses,
        "epochs_run": epochs_run,
        "train_seconds": train_seconds,
    }


# ---------------------------------------------------------------------------
# hyperparameter search (the reference's space)
# ---------------------------------------------------------------------------

SEARCH_SPACE = {
    "lr": [0.0005, 0.001, 0.005, 0.01, 0.05],
    "depth1": [1, 2, 3],
    "depth2": [1, 2, 3],
    "channels_1wl": [24, 32, 64],
    "channels_2wl": [16, 24],
    "dp_emb": np.round(np.arange(0.0, 0.51, 0.1), 1).tolist(),
    "dp_1wl0": np.round(np.arange(0.0, 0.51, 0.1), 1).tolist(),
    "dp_1wl1": np.round(np.arange(0.0, 0.51, 0.1), 1).tolist(),
    "dp_2wl": np.round(np.arange(0.0, 0.51, 0.1), 1).tolist(),
    "act0": [True, False],
    "act1": [True, False],
}


def sample_trial(rng: np.random.Generator) -> dict:
    return {k: v[rng.integers(len(v))] for k, v in SEARCH_SPACE.items()}


# ---------------------------------------------------------------------------
# trial-major refine sweeps
# ---------------------------------------------------------------------------


def _sample_trial_configs(rng: np.random.Generator, n_trials: int
                          ) -> tuple[np.ndarray, dict]:
    """(lrs [T], dropout rates {field: [T]}), float32, drawn from `rng` as
    the JAX package draws them."""
    lrs = np.asarray(rng.choice(SEARCH_SPACE["lr"], size=n_trials)).astype(
        np.float32)
    rates_np = {f: np.asarray(rng.choice(SEARCH_SPACE[f], n_trials),
                              np.float32)
                for f in m.TrialRates._fields}
    return lrs, rates_np


def _trial_rates(rates_np: dict, device, idx=None) -> m.TrialRates:
    return m.TrialRates(**{
        f: torch.as_tensor(v if idx is None else v[idx], dtype=torch.float32,
                           device=device)
        for f, v in rates_np.items()})


def _trial_start(data: TwoWLData, cfg: m.TwoWLConfig, run: TwoWLRunConfig,
                 seed, n_trials: int, rng: np.random.Generator, device):
    """What a trial-major run starts from: the trial-major init and the
    dropout generator (both from `np.random.SeedSequence(seed)`), the Adam
    state, and the static inputs of `train_loop_trials` after the
    parameters (train and val arrays, the `run.epochs` batch schedule drawn
    from `rng`, val labels, node features)."""
    init_seed, drop_seed = np.random.SeedSequence(seed).generate_state(2)
    params = m.init_params_trials(
        cfg, n_trials, torch.Generator().manual_seed(int(init_seed)), device)
    generator = torch.Generator(device=device).manual_seed(int(drop_seed))
    pos_ids, neg_ids = (torch.as_tensor(a, dtype=torch.long, device=device)
                        for a in batch_schedule(data, run, rng))
    inputs = (m.SplitArrays.from_split(data.train, device),
              m.SplitArrays.from_split(data.val, device),
              torch.as_tensor(data.val.y, device=device),
              node_features(cfg, data, device))
    return (params, m.adam_trials_init(params), generator, pos_ids, neg_ids,
            inputs)


def _train_trial_batch(data: TwoWLData, cfg: m.TwoWLConfig,
                       run: TwoWLRunConfig, seed, rng: np.random.Generator,
                       lrs: np.ndarray, rates_np: dict, device,
                       verbose: bool = False) -> tuple:
    """Train one trial-major batch (`lrs` [T], `rates_np` {field: [T]}) for
    `run.epochs` epochs; returns (best_params trial-major, best_aucs [T],
    the seconds of the epoch loop, ending in a device sync)."""
    params, opt_state, generator, pos_ids, neg_ids, (trn, val, val_y, feat) = \
        _trial_start(data, cfg, run, seed, len(lrs), rng, device)
    t0 = time.perf_counter()
    best_params, best_aucs, _ = m.train_loop_trials(
        params, opt_state, generator, pos_ids, neg_ids, trn, val, val_y, feat,
        cfg, torch.as_tensor(lrs, device=device), data.num_nodes,
        _trial_rates(rates_np, device))
    a = best_aucs.cpu().numpy()  # waits for the loop's last kernels
    seconds = time.perf_counter() - t0
    if verbose:
        print(f"  refine {run.epochs} epochs: best val {a.max():.4f} (median "
              f"{np.median(a):.4f} over {len(lrs)} trials) in "
              f"{seconds:.1f}s", flush=True)
    return best_params, best_aucs, seconds


def _finish_refine(data: TwoWLData, cfg: m.TwoWLConfig, best_params: dict,
                   best_aucs: torch.Tensor, lrs: np.ndarray, rates_np: dict,
                   device, verbose: bool) -> dict:
    """The winner by best val AUC, scored on the test split."""
    best_aucs = best_aucs.cpu().numpy()
    winner = int(best_aucs.argmax())
    winner_params = m.extract_trial(best_params, winner)
    tst_auc, tst_scores = evaluate(winner_params, cfg, data, data.test, device)
    fpr, tpr, _ = metrics.roc_curve(data.test.y, tst_scores)
    hp = {"lr": float(lrs[winner]),
          **{f: float(rates_np[f][winner]) for f in m.TrialRates._fields}}
    if verbose:
        print(f"refine: {len(best_aucs)} trials, best val "
              f"{best_aucs[winner]:.4f} ({hp}) test {tst_auc:.4f}")
    return {"best_val": float(best_aucs[winner]), "test_auc": tst_auc,
            "val_aucs": best_aucs, "winner": hp, "params": winner_params,
            "fpr": fpr, "tpr": tpr}


def refine_vmapped(data: TwoWLData, cfg: m.TwoWLConfig, run: TwoWLRunConfig,
                   n_trials: int = 32, seed=None,
                   rng: np.random.Generator | None = None, *, device,
                   verbose: bool = False) -> dict:
    """Trial-major refinement sweep: with the architecture of `cfg` fixed,
    train `n_trials` (lr x dropout) configurations at once for
    `run.epochs` epochs, each keeping its best-val parameters; the winner
    by val AUC is scored on the test split.

    `seed` (default `run.seed`) draws the init and the dropout masks;
    `rng` (default `np.random.default_rng(run.seed + 17)`, the JAX
    package's stream) draws the configurations, then the batch schedule.
    Returns the best val AUC, the winner's test AUC, ROC, hyperparameters
    (`winner`) and parameters, every trial's best val AUC (`val_aucs`) and
    the seconds of the epoch loop (`train_seconds`)."""
    seed = run.seed if seed is None else seed
    rng = rng or np.random.default_rng(run.seed + 17)
    lrs, rates_np = _sample_trial_configs(rng, n_trials)
    best_params, best_aucs, seconds = _train_trial_batch(
        data, cfg, run, seed, rng, lrs, rates_np, device, verbose)
    res = _finish_refine(data, cfg, best_params, best_aucs, lrs, rates_np,
                         device, verbose)
    res["train_seconds"] = seconds
    return res


def refine_halving(data: TwoWLData, cfg: m.TwoWLConfig, run: TwoWLRunConfig,
                   n_trials: int = 64, eta: int = 2, min_trials: int = 8,
                   rung_epochs: int = 250, seed=None,
                   rng: np.random.Generator | None = None, *, device,
                   verbose: bool = False) -> dict:
    """Successive halving: `n_trials` (lr x dropout) configurations start
    in one trial-major run; after each rung of `rung_epochs` epochs the top
    1/`eta` by best val AUC survive warm (parameters, best parameters and
    Adam moments sliced along the trial axis by `m.take_trials`) until
    `min_trials` remain, which train out the rest of `run.epochs`.

    Draws as `refine_vmapped`. Returns its result plus
    `configs_inspected` and the surviving trials' ids (`survivors`)."""
    seed = run.seed if seed is None else seed
    rng = rng or np.random.default_rng(run.seed + 17)
    lrs, rates_np = _sample_trial_configs(rng, n_trials)
    params, opt_state, generator, pos_ids, neg_ids, (trn, val, val_y, feat) = \
        _trial_start(data, cfg, run, seed, n_trials, rng, device)

    E = run.epochs
    chunk = min(E, rung_epochs)
    best = (m.tree_map(lambda p: p.detach().clone(), params),
            torch.full((n_trials,), -1.0, device=device))
    alive = np.arange(n_trials)
    start = 0
    while start < E:
        stop = min(start + chunk, E)
        best = m.train_loop_trials(
            params, opt_state, generator, pos_ids[start:stop],
            neg_ids[start:stop], trn, val, val_y, feat, cfg,
            torch.as_tensor(lrs[alive], device=device), data.num_nodes,
            _trial_rates(rates_np, device, alive), init_best=best)[:2]
        aucs = best[1].cpu().numpy()
        if verbose:
            print(f"  rung epochs {start:4d}-{stop:<4d} {len(alive)} trials "
                  f"best val {aucs.max():.4f} median {np.median(aucs):.4f}",
                  flush=True)
        start = stop
        survivors = max(min_trials, len(alive) // eta)
        if start < E and survivors < len(alive):
            keep = np.sort(np.argsort(-aucs)[:survivors])
            alive = alive[keep]
            params = m.take_trials(params, keep)
            opt_state = m.TrialAdamState(
                mu=m.take_trials(opt_state.mu, keep),
                nu=m.take_trials(opt_state.nu, keep), count=opt_state.count)
            best = (m.take_trials(best[0], keep),
                    best[1][torch.as_tensor(keep, device=device)])

    res = _finish_refine(data, cfg, *best, lrs[alive],
                         {f: v[alive] for f, v in rates_np.items()}, device,
                         verbose)
    res["configs_inspected"] = int(n_trials)
    res["survivors"] = alive.tolist()
    return res


def refine_adaptive(data: TwoWLData, cfg: m.TwoWLConfig, run: TwoWLRunConfig,
                    n_trials: int = 32, n_batches: int = 4,
                    gamma: float = 0.25, explore: float = 0.2, seed=None,
                    rng: np.random.Generator | None = None, *, device,
                    verbose: bool = False) -> dict:
    """Model-based (TPE-class) refinement: `n_batches` trial-major rounds of
    `n_trials // n_batches` configurations, each trained for `run.epochs`.
    Round 1 samples the grid uniformly; each later round samples every
    dimension, with probability `1 - explore`, from a config of the
    top-`gamma` quantile seen so far (moved one grid step with probability
    0.3), else uniformly. The winner of the best round is scored on the
    test split.

    Draws as `refine_vmapped`; round b's init and dropout come from
    `np.random.SeedSequence([seed, b])`. Returns its result plus
    `configs_inspected` and `round_best_vals`."""
    seed = run.seed if seed is None else seed
    rng = rng or np.random.default_rng(run.seed + 17)
    dims = ("lr",) + m.TrialRates._fields
    grids = {d: np.asarray(SEARCH_SPACE[d], np.float32) for d in dims}
    seen_idx: list[np.ndarray] = []  # per-trial grid indices [len(dims)]
    seen_auc: list[float] = []
    batches = []

    def sample_round(nb):
        if not seen_auc:
            return np.stack([
                rng.integers(0, len(grids[d]), nb) for d in dims], axis=1)
        order = np.argsort(-np.asarray(seen_auc))
        good = np.stack([seen_idx[i] for i in
                         order[:max(1, int(len(order) * gamma))]])
        out = np.zeros((nb, len(dims)), np.int64)
        for t in range(nb):
            for j, d in enumerate(dims):
                if rng.random() < explore:
                    out[t, j] = rng.integers(0, len(grids[d]))
                else:
                    v = good[rng.integers(len(good)), j]
                    if rng.random() < 0.3:
                        v = np.clip(v + rng.choice([-1, 1]), 0,
                                    len(grids[d]) - 1)
                    out[t, j] = v
        return out

    nb = max(1, n_trials // n_batches)
    for b in range(n_batches):
        idx = sample_round(nb)
        lrs = grids["lr"][idx[:, 0]]
        rates_np = {d: grids[d][idx[:, j + 1]]
                    for j, d in enumerate(m.TrialRates._fields)}
        best_p, best_a, _ = _train_trial_batch(
            data, cfg, run, [seed, b], rng, lrs, rates_np, device, verbose)
        aucs = best_a.cpu().numpy()
        seen_idx.extend(idx)
        seen_auc.extend(float(a) for a in aucs)
        batches.append((float(aucs.max()), best_p, best_a, lrs, rates_np))
        if verbose:
            print(f"  adaptive round {b + 1}/{n_batches}: best val "
                  f"{aucs.max():.4f} median {np.median(aucs):.4f}",
                  flush=True)

    _, best_p, best_a, lrs, rates_np = max(batches, key=lambda r: r[0])
    res = _finish_refine(data, cfg, best_p, best_a, lrs, rates_np, device,
                         verbose)
    res["configs_inspected"] = len(seen_auc)
    res["round_best_vals"] = [round(r[0], 4) for r in batches]
    return res


REFINE_MODES = {"flat": refine_vmapped, "halving": refine_halving,
                "adaptive": refine_adaptive}


def _load_sweep_state(state_file: str) -> dict:
    done = {}
    if state_file and os.path.exists(state_file):
        with open(state_file) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    done[rec["trial"]] = rec
    return done


def run_twowl(run: TwoWLRunConfig = TwoWLRunConfig(), n_trials: int = 10,
              *, device, data_dir: Optional[str] = None, verbose: bool = True,
              log_file: str = "logs.json",
              state_file: str = "logs/twowl_sweep_state.jsonl",
              roc_dir: str = ".",
              metrics_file: str = "logs/metrics.jsonl",
              refine_trials: int = 0, refine_mode: str = "flat",
              fused: bool = True, roc_png: Optional[str] = None,
              checkpoint_path: Optional[str] = "checkpoints/twowl/model"
              ) -> dict:
    """`n_trials`-trial random search with crash-resume: per-trial results
    append to `state_file`; on restart, completed trials replay from it
    (the RNG stream is re-drawn identically, so pending trials are
    unaffected). Delete the state file for a fresh sweep.

    `refine_trials > 0` adds a trial-major refine round after the search
    (`REFINE_MODES[refine_mode]`: 'flat', 'halving' or 'adaptive') over the
    winner's architecture; if its winner's val AUC is higher, it replaces
    the sweep's winner (one more record line, its lr and dropouts in
    `log_file`).

    Writes the record file under `run.records_dir`, the best trial's
    hyperparameters to `log_file`, its ROC to `roc_dir/{fpr,tpr}.json`, a
    summary line to `metrics_file`, the best parameters to
    `checkpoint_path` (`utils.checkpoint.save_pytree`; None: no checkpoint)
    and, when `roc_png` is a path, the ROC plot (matplotlib is then needed,
    and its absence raises before any work is done). `fused=False` trains
    each trial with the per-epoch host loop `train_routine` instead of
    `train_routine_fused`. The 1-WL aggregation runs on kernel
    K1 and the 2-WL aggregation on K3 (`agg_1wl='ell'`), in the search and
    in the refine.
    """
    if refine_mode not in REFINE_MODES:
        raise ValueError(f"refine_mode must be one of {sorted(REFINE_MODES)}, "
                         f"got {refine_mode!r}")
    if roc_png is not None:
        plots.require_matplotlib()
    routine = train_routine_fused if fused else train_routine
    timer = StepTimer()
    rng = np.random.default_rng(run.seed)
    done = _load_sweep_state(state_file)
    if not done:
        # a fresh sweep starts a fresh record file: one line per trial
        rec_path = records.record_path(run.dataset, "twowl", run.records_dir)
        if os.path.exists(rec_path):
            os.remove(rec_path)

    with timer.span("dataset"):
        edges, num_nodes = load_edges(data_dir)
        data = build_data(edges, num_nodes, run, rng)

    results = []
    best = {"value": -1.0, "params": None, "result": None}
    for trial in range(n_trials):
        t0 = time.perf_counter()
        if trial > 0 and rng.random() < 0.1:  # the reference's 10% rebuild
            with timer.span(f"dataset rebuild (trial {trial})"):
                data = build_data(edges, num_nodes, run, rng)
        hp = sample_trial(rng)
        cfg = m.TwoWLConfig(
            max_degree=data.max_degree,
            agg_1wl="ell",
            channels_1wl=hp["channels_1wl"],
            channels_2wl=hp["channels_2wl"],
            depth1=hp["depth1"],
            depth2=hp["depth2"],
            dp_emb=hp["dp_emb"],
            dp_1wl0=hp["dp_1wl0"],
            dp_1wl1=hp["dp_1wl1"],
            dp_2wl=hp["dp_2wl"],
            act0=hp["act0"],
            act1=hp["act1"],
            learning_rate=hp["lr"],
        )
        if trial in done:
            rec = done[trial]
            res = {
                "best_val": rec["val"], "test_auc": rec["test"],
                "test_eval_seconds": rec.get("eval_seconds", 0.0),
                "fpr": None, "tpr": None, "params": None,
            }
            trial_seconds = rec.get("seconds", 0.0)
        else:
            with timer.span(f"trial {trial}"):
                res = routine(data, cfg, run, device, seed=run.seed + trial,
                              verbose=verbose)
            trial_seconds = time.perf_counter() - t0
            records.write_record(
                run.dataset, "twowl", res["test_auc"],
                res["test_eval_seconds"], run.records_dir, append=trial > 0,
            )
            if state_file:
                records.MetricsLogger(state_file).log(
                    trial=trial, val=float(res["best_val"]),
                    test=float(res["test_auc"]),
                    eval_seconds=res["test_eval_seconds"],
                    seconds=trial_seconds, **hp,
                )
        results.append({**hp, "val": res["best_val"],
                        "test": res["test_auc"], "seconds": trial_seconds})
        if verbose:
            print(f"trial {trial}: val {res['best_val']:.4f} "
                  f"test {res['test_auc']:.4f} ({trial_seconds:.1f}s) {hp}")
        if res["best_val"] > best["value"]:
            best = {"value": res["best_val"], "params": hp, "result": res,
                    "cfg": cfg, "trial": trial}

    if refine_trials > 0:
        with timer.span(f"refine[{refine_mode}] x{refine_trials}"):
            ref = REFINE_MODES[refine_mode](
                data, best["cfg"], run, n_trials=refine_trials,
                seed=run.seed + 10_000, device=device, verbose=verbose)
        if ref["best_val"] > best["value"]:
            best = {
                "value": ref["best_val"], "params": {**best["params"],
                                                     **ref["winner"]},
                "cfg": best["cfg"], "trial": -1,
                "result": {"best_val": ref["best_val"],
                           "test_auc": ref["test_auc"],
                           "test_eval_seconds": 0.0, "fpr": ref["fpr"],
                           "tpr": ref["tpr"], "params": ref["params"]},
            }
            records.write_record(run.dataset, "twowl", ref["test_auc"], 0.0,
                                 run.records_dir, append=True)

    if best["result"]["params"] is None:
        # the winner was a replayed trial: retrain it once for its ROC
        best["result"] = routine(
            data, best["cfg"], run, device, seed=run.seed + best["trial"])

    with open(log_file, "w") as f:
        json.dump(best["params"], f)
    if best["result"]["fpr"] is not None:
        records.write_roc_json(best["result"]["fpr"], best["result"]["tpr"],
                               roc_dir)
        if roc_png is not None:
            plots.plot_roc(best["result"]["fpr"], best["result"]["tpr"],
                           best["result"]["test_auc"], "TwoWL ROC", roc_png)
    if checkpoint_path is not None:
        checkpoint.save_pytree(checkpoint_path, best["result"]["params"])
    records.MetricsLogger(metrics_file).log(
        family="twowl", auc=float(best["result"]["test_auc"]),
        best_val=float(best["value"]), n_trials=n_trials,
        total_seconds=timer.total, best_params=best["params"],
    )
    if verbose:
        print(timer.report())
        print(f"twowl: best val {best['value']:.4f} "
              f"test {best['result']['test_auc']:.4f}")
    return {
        "best_params": best["params"],
        "best_val": best["value"],
        "test_auc": best["result"]["test_auc"],
        "trials": results,
        "total_seconds": timer.total,
    }
