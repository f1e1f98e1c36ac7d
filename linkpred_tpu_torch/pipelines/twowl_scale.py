"""LocalWLNet (TwoWL) end-to-end training at scale — the counterpart of
`linkpred_tpu/pipelines/twowl_scale.py`.

TwoWL's ei2 edge-pair structure is the sum over nodes of deg_in * deg_out
and explodes on larger graphs. This pipeline carries the family to graphs of
50k nodes and more with two capacity bounds: a degree cap on the graph
(random symmetric truncation) and a per-node budget on the ei2 products with
uniform random truncation (`data.twowl.build_ei2_capped`).

Training is the masked static-shape loop of the small-graph path
(`models.twowl.train_loop`, epoch-exact early stop): a free embedding row
per node, seeded by a node2vec run (walks + SGNS) over the train message
graph; dropout off; the 2-WL stack in bf16; Adam under a warm-up cosine
schedule; a val pass every `eval_every` epochs. With `agg_1wl='ell'` the
1-WL aggregation runs on kernel K1 and the 2-WL composed gather-sum, forward
and backward, on kernel K3.

Set-up opens three spans (`utils.profiling`): `twowl_scale.split` over the
graph and split build (`build_scale_data`), `twowl_scale.n2v` over the
node2vec run and its copy into the node table (`seed_node_table`) and
`twowl_scale.operands` over the device operands of the train and val
splits (`split_operands`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.data.synth import (synth_community_graph,
                                           synth_powerlaw_graph)
from linkpred_tpu_torch.data.twowl import TwoWLData, build_twowl_data
from linkpred_tpu_torch.models import twowl as m
from linkpred_tpu_torch.models.word2vec import SGNSConfig, train_sgns_device
from linkpred_tpu_torch.ops.walk import WalkEngine
from linkpred_tpu_torch.pipelines.gcn_scale import resolve_graph_source
from linkpred_tpu_torch.pipelines.twowl_pipeline import (evaluate,
                                                         node_features)
from linkpred_tpu_torch.utils.profiling import span
from linkpred_tpu_torch.utils.progress import LiveProgress


@dataclasses.dataclass(frozen=True)
class ScaleTwoWLConfig:
    nodes: int = 50_000
    edges: int = 250_000
    graph: str = "community"  # or "powerlaw"
    max_degree: int = 32
    # per-node ei2 product budget; None = exact
    ei2_cap_per_node: int | None = 128
    epochs: int = 96
    early_stop: int = 800
    # val AUC every k-th epoch (1 = every epoch): at scale the val forward
    # costs as much as a train epoch
    eval_every: int = 4
    val_ratio: float = 0.02
    test_ratio: float = 0.04
    channels_1wl: int = 24
    channels_2wl: int = 16
    depth1: int = 2
    depth2: int = 2
    learning_rate: float = 0.01
    # linear warm-up, then cosine decay over the planned epochs (0 =
    # constant lr)
    warmup_epochs: int = 10
    seed: int = 0
    # node features: "n2v" = a learnable row per node, initialised by a
    # node2vec/SGNS run over the train message graph; "free" = the same
    # table at its random init (learns slowly: the logit is 4th-order in
    # the rows); "degree" = the degree-indexed table of the small-graph
    # path
    node_feature: str = "n2v"
    n2v_walks_per_node: int = 8
    n2v_walk_length: int = 16
    n2v_epochs: int = 2
    # a real edge dump instead of the synthetic generator
    edges_file: str | None = None
    # feature dtype of the 2-WL stack
    compute_dtype: str = "bf16"
    # pairs per epoch step; 0 = one val-sized minibatch, as on the small
    # graph
    batch_pairs: int = 8192


# untimed epochs on a throwaway copy of the parameters before the timed loop
# (kernel builds, cuBLAS set-up, the allocator's first growth)
WARMUP_EPOCHS = 2
# the epoch loop is cut into calls of about this many epochs (a multiple of
# `eval_every`), each followed by one read of the device for the progress
# line and the early stop
PROGRESS_EPOCHS = 16


def build_scale_data(cfg: ScaleTwoWLConfig) -> TwoWLData:
    """The capped graph and its three TwoWL splits, on the host, array-equal
    to the JAX package's: the same functions called in the same order on the
    same `np.random.default_rng(cfg.seed)`. A `twowl_scale.split` span."""
    with span("twowl_scale.split"):
        cfg, pairs_override = resolve_graph_source(cfg)
        rng = np.random.default_rng(cfg.seed)
        if pairs_override is not None:
            lo, hi = pairs_override
        else:
            synth = (synth_community_graph if cfg.graph == "community"
                     else synth_powerlaw_graph)
            lo, hi = synth(cfg.nodes, cfg.edges, seed=cfg.seed)
        g = Graph.from_undirected_edges(lo, hi, num_nodes=cfg.nodes)
        g = g.with_degree_cap(cfg.max_degree, rng=rng, symmetric=True)
        pairs = np.stack([g.src, g.dst], axis=1)
        pairs = pairs[pairs[:, 0] < pairs[:, 1]]  # undirected pairs once
        return build_twowl_data(
            pairs, cfg.nodes, rng=rng,
            val_ratio=cfg.val_ratio, test_ratio=cfg.test_ratio,
            ei2_cap_per_node=cfg.ei2_cap_per_node,
        )


def split_operands(data: TwoWLData, device) -> tuple:
    """The (train, val) `SplitArrays` on `device`, ready on return. A
    `twowl_scale.operands` span."""
    with span("twowl_scale.operands"):
        arrays = (m.SplitArrays.from_split(data.train, device),
                  m.SplitArrays.from_split(data.val, device))
        _sync(torch.device(device))
    return arrays


def model_config(cfg: ScaleTwoWLConfig, data: TwoWLData,
                 agg_1wl: str = "ell") -> m.TwoWLConfig:
    """The model of a scale run: dropout off (the masked minibatch is a
    small fraction of the graph, and the short schedule is steadier
    without), act0 on, act1 off."""
    free = cfg.node_feature in ("free", "n2v")
    return m.TwoWLConfig(
        max_degree=(data.num_nodes - 1) if free else data.max_degree,
        degree_feature=not free,
        channels_1wl=cfg.channels_1wl, channels_2wl=cfg.channels_2wl,
        depth1=cfg.depth1, depth2=cfg.depth2,
        dp_emb=0.0, dp_1wl0=0.0, dp_1wl1=0.0, dp_2wl=0.0,
        act0=True, act1=False,
        learning_rate=cfg.learning_rate,
        compute_dtype=cfg.compute_dtype,
        agg_1wl=agg_1wl,
    )


def n2v_embeddings(cfg: ScaleTwoWLConfig, data: TwoWLData, device,
                   seed: int) -> torch.Tensor:
    """node2vec embeddings [N, channels_1wl] on `device`, from walks and
    SGNS over the train message graph only (no held-out edge). Walks and
    SGNS draw from device generators seeded `seed` and `seed + 1`; the walk
    matrix stays on the device between the two."""
    msg = data.train.msg[::2]
    gm = Graph.from_undirected_edges(msg[:, 0], msg[:, 1],
                                     num_nodes=data.num_nodes)
    walks = WalkEngine(gm, device=device).walks(
        torch.Generator(device=device).manual_seed(seed),
        cfg.n2v_walks_per_node, cfg.n2v_walk_length)
    return train_sgns_device(
        torch.Generator(device=device).manual_seed(seed + 1), walks,
        data.num_nodes,
        SGNSConfig(dim=cfg.channels_1wl, window=5, epochs=cfg.n2v_epochs,
                   batch_size=65536))


def seed_node_table(cfg: ScaleTwoWLConfig, data: TwoWLData, params: dict,
                    device, seed: int) -> None:
    """Copy `n2v_embeddings(cfg, data, device, seed)` into the node table
    `params["emb"]`, ready on return. A `twowl_scale.n2v` span."""
    with span("twowl_scale.n2v"):
        emb0 = n2v_embeddings(cfg, data, device, seed)
        with torch.no_grad():
            params["emb"].copy_(emb0)
        _sync(torch.device(device))


def lr_schedule(cfg: ScaleTwoWLConfig) -> np.ndarray | None:
    """The learning rate of every planned epoch, [cfg.epochs] float64, or
    None for a constant rate (`warmup_epochs == 0`)."""
    if cfg.warmup_epochs <= 0:
        return None
    schedule = m.warmup_cosine_schedule(
        init_value=cfg.learning_rate * 0.05,
        peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_epochs,
        decay_steps=max(cfg.epochs, cfg.warmup_epochs + 1),
        end_value=cfg.learning_rate * 0.02,
    )
    return schedule(np.arange(cfg.epochs))


def batch_schedule(cfg: ScaleTwoWLConfig, data: TwoWLData
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Per-epoch sampled train pair ids, `[E, P]` int32 each (positives,
    negatives), from `np.random.default_rng(cfg.seed)` as the JAX package
    draws them. P is capped at 1/8 of the train positives: the batch's
    positives leave the message graph, so a batch near the edge count would
    train on a near-empty graph."""
    n_pos_pairs = data.train.num_msg // 2
    n_neg_pairs = len(data.train.pred) // 2
    base = cfg.batch_pairs if cfg.batch_pairs > 0 else len(data.val.y)
    P = max(1, min(base, n_pos_pairs // 8, n_neg_pairs))
    rng = np.random.default_rng(cfg.seed)
    pos_ids = np.stack([rng.permutation(n_pos_pairs)[:P]
                        for _ in range(cfg.epochs)]).astype(np.int32)
    neg_ids = np.stack([rng.permutation(n_neg_pairs)[:P]
                        for _ in range(cfg.epochs)]).astype(np.int32)
    return pos_ids, neg_ids


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_and_score(cfg: ScaleTwoWLConfig, data: TwoWLData, arrays: tuple,
                    params: dict, device, agg_1wl: str = "ell",
                    verbose: bool = False) -> dict:
    """Train `params` (in place) on `data` for `cfg.epochs` epochs and score
    the test split with the best-val parameters. `arrays` is the (train,
    val) pair of `SplitArrays` on `device`. The timed loop starts from the
    given parameters after `WARMUP_EPOCHS` untimed epochs on a throwaway
    copy of them, and is cut into calls of about `PROGRESS_EPOCHS` epochs
    that carry the best parameters along (`train_loop(init_best=)`).
    Returns `run_twowl_scale`'s keys but those of the build and the
    seeding."""
    device = torch.device(device)
    trn, val = arrays
    mcfg = model_config(cfg, data, agg_1wl)
    pos_ids, neg_ids = (torch.as_tensor(a, dtype=torch.long, device=device)
                        for a in batch_schedule(cfg, data))
    E = cfg.epochs
    lrs = lr_schedule(cfg)
    val_y = torch.as_tensor(data.val.y, device=device)
    node_deg = node_features(mcfg, data, device)

    def loop(p, opt, start, stop, best):
        return m.train_loop(
            p, opt, None, pos_ids[start:stop], neg_ids[start:stop], trn, val,
            val_y, node_deg, mcfg, data.num_nodes, early_stop=cfg.early_stop,
            eval_every=cfg.eval_every, init_best=best,
            lr_schedule=None if lrs is None else lrs[start:stop])

    warm = m.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loop(warm, m.adam(warm, mcfg.learning_rate), 0, min(WARMUP_EPOCHS, E),
         None)
    _sync(device)
    del warm

    chunk = max(1, PROGRESS_EPOCHS // cfg.eval_every) * cfg.eval_every
    progress = LiveProgress(E, label="twowl-scale") if verbose else None
    optimizer = m.adam(params, mcfg.learning_rate)
    best, hists = None, []
    t0 = time.perf_counter()
    for start in range(0, E, chunk):
        stop = min(start + chunk, E)
        best_p, best_a, since, (losses, _) = loop(params, optimizer, start,
                                                  stop, best)
        best = (best_p, best_a, since)
        since_host = int(since)  # waits for the chunk's last kernels
        hists.append(losses.cpu().numpy())
        if verbose:
            for k, lv in enumerate(hists[-1]):
                progress.update(start + k + 1, loss=float(lv))
            progress.update(stop, auc=float(best_a))
        if since_host > cfg.early_stop:
            break
    train_seconds = time.perf_counter() - t0
    if verbose:
        progress.close()
    losses = np.concatenate(hists)

    tst_auc, _ = evaluate(best[0], mcfg, data, data.test, device)
    q = max(len(losses) // 4, 1)
    first_q, last_q = float(losses[:q].mean()), float(losses[-q:].mean())
    return {
        "nodes": data.num_nodes,
        "msg_edges": int(data.train.num_msg),
        "ei2_columns": int(len(data.train.e1_src)),
        "ei2_cap_per_node": cfg.ei2_cap_per_node,
        "epochs": int(len(losses)),
        "loss_first_quarter": first_q,
        "loss_last_quarter": last_q,
        "loss_decreased": bool(last_q < first_q),
        "best_val_auc": float(best[1]),
        "test_auc": float(tst_auc),
        "train_seconds": round(train_seconds, 3),
        "epochs_per_s": round(len(losses) / max(train_seconds, 1e-9), 2),
        "compile_seconds": 0.0,
        "node_feature": cfg.node_feature,
    }


def run_twowl_scale(cfg: ScaleTwoWLConfig = ScaleTwoWLConfig(), device=None,
                    agg_1wl: str = "ell", verbose: bool = True) -> dict:
    """Build, seed, train and score on `device` (default the visible card;
    no card raises). Returns the JAX package's result keys, plus
    `operand_seconds`, the host build and upload of the train and val
    operands (`build_seconds` is the graph and split build alone).
    `compile_seconds` is 0.0: nothing compiles; `epochs_per_s` is over all
    epochs run."""
    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)

    t0 = time.perf_counter()
    data = build_scale_data(cfg)
    build_seconds = time.perf_counter() - t0

    init_seed, n2v_seed = (int(s) for s in np.random.SeedSequence(
        cfg.seed).generate_state(2))
    params = m.init_params(model_config(cfg, data, agg_1wl),
                           torch.Generator().manual_seed(init_seed), device)
    n2v_seconds = 0.0
    if cfg.node_feature == "n2v":
        tn = time.perf_counter()
        seed_node_table(cfg, data, params, device, n2v_seed)
        n2v_seconds = time.perf_counter() - tn

    t0 = time.perf_counter()
    arrays = split_operands(data, device)
    operand_seconds = time.perf_counter() - t0

    out = train_and_score(cfg, data, arrays, params, device, agg_1wl, verbose)
    out.update(build_seconds=round(build_seconds, 1),
               operand_seconds=round(operand_seconds, 1),
               n2v_seconds=round(n2v_seconds, 1))
    if verbose:
        print(f"twowl-scale: {cfg.nodes} nodes, "
              f"{out['ei2_columns']} ei2 cols, loss "
              f"{out['loss_first_quarter']:.4f} -> "
              f"{out['loss_last_quarter']:.4f}, test AUC "
              f"{out['test_auc']:.4f}, {out['epochs_per_s']} epochs/s on "
              f"{device}")
    return out
