"""Model family C, TwoWL: training routine and hyperparameter search — the
counterpart of `linkpred_tpu/pipelines/twowl_pipeline.py`.

1. load fb-pages-food and build the 85/5/10 split with doubled edges and
   ei2 edge-pair structures (the shared JAX-free host builder
   `linkpred_tpu.data.twowl`),
2. per epoch: one val-sized minibatch of positive + negative pairs, the
   positives masked out of the message graph, Adam, val AUC on the device,
3. early stop, best-val params, test AUC, and the reference-format outputs
   (`AUC:x   Time:y` record, `fpr.json`/`tpr.json`, `logs.json`),
4. a seeded random search over the reference's hyperparameter space.

The batch schedules come from `np.random.default_rng(run.seed)` exactly as
in the JAX package, so both see the same batches. Not ported yet: the
unfused `train_routine`, the trial-major refine sweeps, the ROC PNG and the
parameter checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from linkpred_tpu.data import io
from linkpred_tpu.data.twowl import TwoWLData, TwoWLSplit, build_twowl_data
from linkpred_tpu_torch.models import twowl as m
from linkpred_tpu_torch.utils import metrics, records
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


def batch_schedule(data: TwoWLData, run: TwoWLRunConfig
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Per-epoch sampled train pair ids, `[E, P]` int32 each (positives,
    negatives), drawn exactly as the reference draws them: one val-sized
    minibatch per epoch, half positives, half negatives."""
    n_pos_pairs = data.train.num_msg // 2
    n_neg_pairs = len(data.train.pred) // 2
    P = min(len(data.val.y), n_pos_pairs, n_neg_pairs)
    rng = np.random.default_rng(run.seed)
    E = run.epochs
    pos_ids = np.stack(
        [rng.permutation(n_pos_pairs)[:P] for _ in range(E)]).astype(np.int32)
    neg_ids = np.stack(
        [rng.permutation(n_neg_pairs)[:P] for _ in range(E)]).astype(np.int32)
    return pos_ids, neg_ids


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
    seed = run.seed if seed is None else seed
    init_seed, drop_seed = np.random.SeedSequence(seed).generate_state(2)
    if params is None:
        params = m.init_params(
            cfg, torch.Generator().manual_seed(int(init_seed)), device)
    generator = torch.Generator(device=device).manual_seed(int(drop_seed))
    optimizer = m.adam(params, cfg.learning_rate)

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
              metrics_file: str = "logs/metrics.jsonl") -> dict:
    """`n_trials`-trial random search with crash-resume: per-trial results
    append to `state_file`; on restart, completed trials replay from it
    (the RNG stream is re-drawn identically, so pending trials are
    unaffected). Delete the state file for a fresh sweep.

    Writes the record file under `run.records_dir`, the best trial's
    hyperparameters to `log_file`, its ROC to `roc_dir/{fpr,tpr}.json` and
    a summary line to `metrics_file`. The 1-WL aggregation runs on kernel
    K1 (`agg_1wl='ell'`).
    """
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
                res = train_routine_fused(data, cfg, run, device,
                                          seed=run.seed + trial,
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

    if best["result"]["params"] is None:
        # the winner was a replayed trial: retrain it once for its ROC
        best["result"] = train_routine_fused(
            data, best["cfg"], run, device, seed=run.seed + best["trial"])

    with open(log_file, "w") as f:
        json.dump(best["params"], f)
    records.write_roc_json(best["result"]["fpr"], best["result"]["tpr"],
                           roc_dir)
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
