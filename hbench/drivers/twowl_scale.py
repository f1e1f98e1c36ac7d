"""Driver of TwoWL at scale (`pipelines/twowl_scale.py`): one trial of the
scale path's model (a learnable row per node seeded by node2vec, the 2-WL
stack at the configuration's `model.dtype`) on its synthetic graph, trained
by the port's `models/twowl.train_loop` as `train_and_score` trains it, at
the configuration's `eval_every` and learning-rate schedule (the cell's: a
val pass every epoch at a constant rate, so every epoch replays one CUDA
graph), with no early stop.

`build` is the port's host build and operands (`build_scale_data`,
`split_operands`), timed as `build_s`. `start` draws the run's inputs from
the seed: the initial parameters (`init_params` from a CPU generator), the
node2vec run copied into the node table (`seed_node_table`) and the epochs'
train pairs (`batch_schedule` at a seed of the run's); then, as the
fb-pages driver does, it drives the window's own call through the first
three epochs, one a call, keeping what the check compares, and warms the
window's chunk. The reference (`reference/twowl_scale.py`) builds its own
graph and splits from the generated pairs and takes the program's draws
that it cannot replay, counting their faults into `build`.

The three epochs start from the program's parameters, node table
included, so the check holds the node2vec stage apart: the reference runs
a node2vec of its own (walks and SGNS, at its own seed) over its message
graph, and `n2v_auc` and `n2v_norm` hold the program's table against that
one (`n2v_readings`).

`build` and `Run` fall back to the unspanned calls that `split_operands`
and `seed_node_table` make on a program that lacks those two (a tree older
than the set-up spans); the fallback goes once no compared tree lacks them
(`ROADMAP.md`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from hbench import check, harness, work
from hbench.drivers import twowl
from hbench.reference import twowl as ref
from hbench.reference import twowl_scale as scale_ref

CHECKED_STEPS = twowl.CHECKED_STEPS
TRACE_STEPS = 10  # epochs in a profiler capture
# the control of each precision the family runs: the reference with the
# 2-WL stack's stored tensors rounded one step below (`reference/
# twowl_scale.rounder`) in the program's place
CONTROL_PRECISION = {"bf16": "e4m3"}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
N2V_WINDOW = 5  # the scale path's SGNS window (`n2v_embeddings`)


def scale_config(config: dict, traffic: dict):
    """The `ScaleTwoWLConfig` of a configuration file: its `scale` fields,
    its model's widths, rate and dtype, the data seed, and the traffic's
    schedule length as the epochs planned."""
    from linkpred_tpu_torch.pipelines import twowl_scale as ts

    model = config["model"]
    return ts.ScaleTwoWLConfig(
        **config["scale"], channels_1wl=model["channels_1wl"],
        channels_2wl=model["channels_2wl"], depth1=model["depth1"],
        depth2=model["depth2"], learning_rate=model["lr"],
        compute_dtype=model["dtype"], epochs=traffic["schedule_epochs"],
        seed=config["data_seed"])


def build(config: dict, traffic: dict, device) -> dict:
    from linkpred_tpu_torch.pipelines import twowl_scale as ts

    t0 = time.perf_counter()
    cfg = scale_config(config, traffic)
    data = ts.build_scale_data(cfg)
    if hasattr(ts, "split_operands"):
        trn, val = ts.split_operands(data, device)
    else:  # a port without the set-up spans: the same calls, unspanned
        trn, val = (ts.m.SplitArrays.from_split(s, device)
                    for s in (data.train, data.val))
    return {"cfg": cfg, "data": data, "trn": trn, "val": val,
            "num_nodes": data.num_nodes, "build_s": time.perf_counter() - t0}


class Run(twowl.Run):
    """One seeded run of the scale cell on the program: the fb-pages
    driver's single-trial run (its checked epochs, chunks and schedule
    cycling) over the scale path's inputs."""

    def __init__(self, built: dict, config: dict, traffic: dict, seed: int,
                 device):
        from linkpred_tpu_torch.models import twowl as m
        from linkpred_tpu_torch.pipelines import twowl_scale as ts
        from linkpred_tpu_torch.pipelines.twowl_pipeline import node_features

        self.m, self.built, self.config = m, built, config
        self.device = device
        self.trials, self.generator, self._rd = None, None, None
        self._ref_table = None
        cfg, data = built["cfg"], built["data"]
        init_seed, n2v_seed, batch_seed, self.ref_n2v_seed = twowl._seeds(
            seed)
        self.cfg = ts.model_config(cfg, data, config["model"]["agg_1wl"])
        params = m.init_params(self.cfg,
                               torch.Generator().manual_seed(init_seed),
                               device)
        if cfg.node_feature == "n2v" and hasattr(ts, "seed_node_table"):
            ts.seed_node_table(cfg, data, params, device, n2v_seed)
        elif cfg.node_feature == "n2v":  # a port without the set-up spans
            with torch.no_grad():
                params["emb"].copy_(ts.n2v_embeddings(cfg, data, device,
                                                      n2v_seed))
        self.params = params
        self.layout = m.tree_map(lambda p: None, params)  # keys and lists
        self.opt = m.adam(params, self.cfg.learning_rate)
        self.eval_every, self.lrs = cfg.eval_every, ts.lr_schedule(cfg)
        pos, neg = ts.batch_schedule(dataclasses.replace(cfg, seed=batch_seed),
                                     data)
        self.pos_np, self.neg_np = pos, neg
        self.batch = pos.shape[1]
        self.pos = torch.as_tensor(pos, dtype=torch.long, device=device)
        self.neg = torch.as_tensor(neg, dtype=torch.long, device=device)
        self.val_y = torch.as_tensor(data.val.y, device=device)
        self.feat = node_features(self.cfg, data, device)
        self.best = (m.tree_map(lambda p: p.detach().clone(), params),
                     torch.tensor(-1.0, device=device))
        self.cursor = 0
        self.chunk_epochs = traffic["chunk_epochs"]
        self.snapshot = self._checked_steps()
        self.chunk()  # warm the window's chunk

    def _call(self, lo: int, hi: int) -> tuple:
        b = self.built
        best_params, best_auc, since, (losses, aucs) = self.m.train_loop(
            self.params, self.opt, None, self.pos[lo:hi], self.neg[lo:hi],
            b["trn"], b["val"], self.val_y, self.feat, self.cfg,
            b["num_nodes"], early_stop=None, eval_every=self.eval_every,
            init_best=self.best,
            lr_schedule=None if self.lrs is None else self.lrs[lo:hi])
        self.best = (best_params, best_auc, since)
        return losses, aucs

    # -- what the traced run reads ------------------------------------

    def reference_data(self) -> dict:
        """`reference_data` of this run's build, made once."""
        if self._rd is None:
            self._rd = reference_data(self.built)
        return self._rd

    def reference_table(self) -> torch.Tensor:
        """`reference_table` of this run (made once)."""
        if self._ref_table is None:
            self._ref_table = reference_table(
                self.built, self.reference_data(), self.ref_n2v_seed,
                self.device)
        return self._ref_table

    def ops(self) -> list:
        """The epoch's K3 and K1 calls at this cell's operands, with the
        yardstick's work from the reference's own structures: per epoch the
        train step's degree pass (f32), `depth2` forward and `depth2`
        transposed 2-WL gather-sums and `depth1` 1-WL aggregations (f32),
        and the val pass's degree pass, gather-sums and aggregations; the
        2-WL sums at the configuration's dtype."""
        from linkpred_tpu_torch.ops import hopper_kernels as hk

        rd = self.reference_data()
        model = self.config["model"]
        dtype = model["dtype"]
        w2 = 2 * model["channels_2wl"]
        dims = [model["channels_1wl"]] * model["depth1"] + [
            model["channels_2wl"]]
        n, n_msg = self.built["num_nodes"], len(rd["msg"])
        dev = self.device
        ops = []
        for name, arrays in (("train", self.built["trn"]),
                             ("val", self.built["val"])):
            r = n_msg + len(rd[name]["pred"])
            a, b = rd[name]["ei2"][:, 0], rd[name]["ei2"][:, 1]
            fwd, bwd = arrays.e1_cops
            ones = torch.ones((arrays.num_rows, 1), device=dev)
            x = torch.randn((arrays.num_rows, w2), device=dev).to(
                DTYPES[dtype])
            ops.append({"kernel": "k3", "what": f"{name} degree pass",
                        "fn": lambda x=ones, k=fwd.k3: hk.spmm_bucketed(x, *k),
                        "calls": 1, **work.aggregation_work(a ^ 1, r, 1,
                                                            "f32")})
            ops.append({"kernel": "k3", "what": f"{name} 2-WL forward",
                        "fn": lambda x=x, k=fwd.k3: hk.spmm_bucketed(x, *k),
                        "calls": model["depth2"],
                        **work.aggregation_work(a ^ 1, r, w2, dtype)})
            if name == "train":
                ops.append({"kernel": "k3", "what": "train 2-WL transposed",
                            "fn": lambda x=x, k=bwd.k3: hk.spmm_bucketed(
                                x, *k),
                            "calls": model["depth2"],
                            **work.aggregation_work(b, r, w2, dtype)})
            for i in range(model["depth1"]):
                f = dims[i + 1]
                msgs = torch.randn((n_msg, f), device=dev)
                ops.append({"kernel": "k1", "what": f"{name} 1-WL F={f}",
                            "fn": lambda x=msgs, s=arrays: hk.spmm_ell(
                                s.msg_slots, s.msg_sweight, x),
                            "calls": 1,
                            **work.aggregation_work(np.arange(n_msg), n, f,
                                                    "f32")})
        return ops

    def flops_per_step(self) -> tuple[int, str]:
        """Model FLOPs of an epoch (the train step and the val pass, from
        the reference's shapes), held to the peak of the configuration's
        dtype; the 1-WL stack's f32 share is logged."""
        rd = self.reference_data()
        model = self.config["model"]
        n_msg = len(rd["msg"])

        total = work.twowl_epoch_flops(
            self.built["num_nodes"], n_msg,
            n_msg + len(rd["train"]["pred"]), len(rd["train"]["ei2"]),
            n_msg + len(rd["val"]["pred"]), len(rd["val"]["ei2"]),
            2 * self.batch, len(rd["val"]["y"]), model["channels_1wl"],
            model["channels_2wl"], model["depth1"], model["depth2"], 1)
        dims = [model["channels_1wl"]] * model["depth1"] + [
            model["channels_2wl"]]
        # the 1-WL stack runs in f32: its matmuls and aggregations in the
        # train step (forward and backward, 3x) and the val pass
        one_wl = 4 * sum(
            work.matmul_flops(self.built["num_nodes"], dims[i], dims[i + 1])
            + 2 * n_msg * dims[i + 1] for i in range(model["depth1"]))
        harness.log(f"flops an epoch: {total}, of them 1-WL (f32) {one_wl},"
                    f" the rest ({model['dtype']}) {total - one_wl}")
        return total, model["dtype"]


def reference_data(built: dict) -> dict:
    """The reference's own graph, splits and ei2 from the generated pairs,
    with the program's draws that it cannot replay."""
    from linkpred_tpu_torch.data import synth

    cfg = built["cfg"]
    generate = (synth.synth_community_graph if cfg.graph == "community"
                else synth.synth_powerlaw_graph)
    lo, hi = generate(cfg.nodes, cfg.edges, seed=cfg.seed)
    return scale_ref.build_data(
        lo, hi, cfg.nodes, cfg.max_degree, cfg.ei2_cap_per_node,
        cfg.val_ratio, cfg.test_ratio, cfg.seed, program_draws(built["data"]))


def program_draws(data) -> dict:
    """The program's draws the reference cannot replay: the val, test and
    train negatives as undirected pairs and each split's live ei2
    products."""
    def negatives(s):
        n_pos = int(s.y.sum())
        return s.pred[2 * n_pos::2]

    return {"val_neg": negatives(data.val), "test_neg": negatives(data.test),
            "train_neg": data.train.pred[0::2],
            "ei2": {name: np.stack([s.e1_src[s.e1_mask], s.e1_dst[s.e1_mask]],
                                   axis=1)
                    for name, s in (("train", data.train),
                                    ("val", data.val))}}


def build_faults(built: dict, rd: dict) -> int:
    """Structural faults of the program's host build against the
    reference's: the faults of the draws the reference took
    (`reference/twowl_scale.build_data`), and the message edges, the val
    and test positives and the val labels, which it makes itself."""
    data = built["data"]

    def differ(a, b) -> int:
        a, b = np.asarray(a), np.asarray(b)
        return int(a.shape != b.shape or not np.array_equal(a, b))

    split = rd["split"]
    n_v, n_t = len(split["val_pos"]), len(split["test_pos"])
    faults = rd["faults"]
    faults += differ(data.train.msg, rd["msg"])
    faults += differ(data.val.msg, rd["msg"])
    faults += differ(data.val.pred[:2 * n_v], ref.double(split["val_pos"]))
    faults += differ(data.test.pred[:2 * n_t], ref.double(split["test_pos"]))
    faults += differ(data.val.y, rd["val"]["y"])
    return faults


def reference_table(built: dict, rd: dict, seed: int,
                    device) -> torch.Tensor:
    """The reference's own node2vec table (host, [N, C]): the
    configuration's walks, walk length, SGNS epochs and width over the
    reference's message graph, at `seed`."""
    cfg = built["cfg"]
    return scale_ref.node2vec(
        rd["msg"], built["num_nodes"], cfg.n2v_walks_per_node,
        cfg.n2v_walk_length, cfg.n2v_epochs, cfg.channels_1wl, N2V_WINDOW,
        seed, device).cpu()


def n2v_readings(rd: dict, mine: torch.Tensor, table: torch.Tensor) -> dict:
    """A node table made by node2vec (`table`, [N, C]) against the
    reference's own (`mine`, `reference_table`), each on the held-out
    pairs of the reference's data `rd` (val and test, positives and
    negatives):

    - `n2v_auc`: the reference table's AUC of row dot products less the
      table's (a table that predicts the held-out links worse reads high;
      one that predicts them better reads below 0);
    - `n2v_norm`: |log| of the ratio of the median row norms (SGNS grows
      the rows as it trains, so a run cut short reads high)."""
    split = rd["split"]
    pos = np.concatenate([split["val_pos"], split["test_pos"]])
    neg = np.concatenate([split["val_neg"], split["test_neg"]])
    table = table.detach().float().cpu()
    ratio = (float(table.norm(dim=1).median())
             / float(mine.norm(dim=1).median()))
    return {"n2v_auc": (scale_ref.table_auc(mine, pos, neg)
                        - scale_ref.table_auc(table, pos, neg)),
            "n2v_norm": abs(float(np.log(max(ratio, 1e-30))))}


def readings(run: Run, control_precision: str | None = None) -> dict:
    """The numbers of `check` for this run: the program's first three
    epochs (or, with `control_precision`, the reference's at that
    precision put in the program's place) against the reference's at the
    configuration's precision; with a node2vec table, `n2v_readings` of
    the program's."""
    rd = run.reference_data()
    model = run.config["model"]
    batches = [(run.pos_np[k], run.neg_np[k]) for k in range(CHECKED_STEPS)]
    start = run.snapshot["start"]
    params0 = ref.tree_like(run.layout, start)
    truth = scale_ref.train_steps(params0, model, rd, batches, run.device,
                                  model["dtype"])
    if control_precision is None:
        prog = dict(run.snapshot)
    else:
        prog = scale_ref.train_steps(params0, model, rd, batches, run.device,
                                     control_precision)
        prog["start"] = start
    out = check.twowl_readings(prog, {**truth, "start": start}, None)
    out["build"] = build_faults(run.built, rd)
    if run.built["cfg"].node_feature == "n2v":
        out.update(n2v_readings(rd, run.reference_table(),
                                params0["emb"]))
    return out


def start(built: dict, config: dict, traffic: dict, seed: int, device) -> Run:
    return Run(built, config, traffic, seed, device)
