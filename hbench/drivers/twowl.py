"""Driver of the TwoWL family (`models/twowl.py`) on fb-pages-food: the
trial-major sweep (`train_loop_trials`, traffic `"loop": "trials"`) or one
trial (`train_loop`, `"loop": "single"`), every epoch trained, no early stop.

`build` is the port's host build and layout (`build_data` and
`SplitArrays.from_split`), timed as `build_s`. `start` makes the run's
inputs from the seed on the card (the weights in a few large draws, the
dropout generator) and on the host (the trials' learning rates and dropout
rates, the batch schedule), drives the window's own call through the first
three epochs, one epoch a call, keeping what the check compares, and warms
the window's chunk. The window then calls the loop on chunks of epochs,
carrying the parameters, the optimizer and the best-val state, with no host
read until its end.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from hbench import check, work
from hbench.reference import twowl as ref

DATA_DIR = Path(__file__).resolve().parents[1] / "data"
CHECKED_STEPS = 3
TRACE_STEPS = 10  # epochs in a profiler capture
# the control of each precision the family runs: the reference one step
# below it (`reference/precision.py`) in the program's place
CONTROL_PRECISION = {"f32": "tf32"}
ADAM_B1 = 0.9  # the first moment's decay of both optimizers


def _seeds(seed: int) -> list[int]:
    """Independent 63-bit seeds for the weights, the dropout masks, the
    trials' rates and the batch schedule."""
    state = np.random.SeedSequence(seed).generate_state(4, dtype=np.uint64)
    return [int(s) & (2**63 - 1) for s in state]


def build(config: dict, traffic: dict, device) -> dict:
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp

    t0 = time.perf_counter()
    edges, num_nodes = tp.load_edges(str(DATA_DIR))
    data = tp.build_data(edges, num_nodes, tp.TwoWLRunConfig(),
                         np.random.default_rng(config["data_seed"]))
    trn = m.SplitArrays.from_split(data.train, device)
    val = m.SplitArrays.from_split(data.val, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"data": data, "trn": trn, "val": val, "num_nodes": num_nodes,
            "build_s": time.perf_counter() - t0}


def _draw_params(model: dict, rows: int, trials: int | None, gen,
                 device) -> dict:
    """The reference's init (degree embedding N(0, 1), Glorot-uniform
    weights, zero biases, GraphNorm at weight 1, bias 0, mean scale 1) in
    the program's layout, drawn on `device` in two calls."""
    t = () if trials is None else (trials,)
    c1, c2 = model["channels_1wl"], model["channels_2wl"]
    dims = [c1] * model["depth1"] + [c2]
    mats = ([(dims[i], dims[i + 1]) for i in range(model["depth1"])]
            + [(c2, c2)] * (2 * model["depth2"]) + [(c2, 1)])
    emb_shape = (rows, *t, c1)
    normal = torch.randn(emb_shape, generator=gen, device=device)
    uniform = torch.rand(int(sum(np.prod((*t, a, b)) for a, b in mats)),
                         generator=gen, device=device)
    glorot, off = [], 0
    for a, b in mats:
        n = int(np.prod((*t, a, b)))
        lim = float(np.sqrt(6.0 / (a + b)))
        glorot.append((uniform[off:off + n].view(*t, a, b) * 2 - 1) * lim)
        off += n

    def gn(d):
        return {"weight": torch.ones((*t, d), device=device),
                "bias": torch.zeros((*t, d), device=device),
                "mean_scale": torch.ones((*t, d), device=device)}

    def conv(w):
        return {"w": w, "b": torch.zeros((*t, w.shape[-1]), device=device),
                "gn": gn(w.shape[-1])}

    d1, d2 = model["depth1"], model["depth2"]
    params = {"emb": normal, "emb_gn": gn(c1),
              "conv1": [conv(glorot[i]) for i in range(d1)],
              "conv2": [conv(glorot[d1 + i]) for i in range(d2)],
              "conv2r": [conv(glorot[d1 + d2 + i]) for i in range(d2)],
              "pred_w": glorot[-1],
              "pred_b": torch.zeros((*t, 1), device=device)}
    return params


def _schedule(rng: np.random.Generator, epochs: int, n_pos: int, n_neg: int,
              batch: int) -> tuple[np.ndarray, np.ndarray]:
    """`epochs` batches of `batch` distinct positive and negative pair
    ids each, every epoch a fresh draw: the same sizes for every seed."""
    pos = np.stack([rng.permutation(n_pos)[:batch] for _ in range(epochs)])
    neg = np.stack([rng.permutation(n_neg)[:batch] for _ in range(epochs)])
    return pos, neg


class Run:
    """One seeded run of a TwoWL cell on the program: its state, the
    window's call, and what the check compares."""

    def __init__(self, built: dict, config: dict, traffic: dict, seed: int,
                 device):
        from linkpred_tpu_torch.models import twowl as m

        self.m, self.built, self.config = m, built, config
        self.device = device
        data = built["data"]
        model = config["model"]
        self.trials = (traffic["trials"] if traffic["loop"] == "trials"
                       else None)
        w_seed, d_seed, r_seed, b_seed = _seeds(seed)
        self.dropout_seed = d_seed
        self.cfg = m.TwoWLConfig(
            max_degree=data.max_degree, agg_1wl=model["agg_1wl"],
            channels_1wl=model["channels_1wl"],
            channels_2wl=model["channels_2wl"], depth1=model["depth1"],
            depth2=model["depth2"], dp_emb=model["dp_emb"],
            dp_1wl0=model["dp_1wl0"], dp_1wl1=model["dp_1wl1"],
            dp_2wl=model["dp_2wl"], act0=model["act0"], act1=model["act1"],
            learning_rate=model["lr"])
        gen = torch.Generator(device=device).manual_seed(w_seed)
        params = _draw_params(model, data.max_degree + 1, self.trials, gen,
                              device)
        self.params = m.tree_map(lambda p: p.requires_grad_(), params)
        self.layout = m.tree_map(lambda p: None, params)  # keys and lists
        self.generator = torch.Generator(device=device).manual_seed(d_seed)
        rng = np.random.default_rng(r_seed)
        if self.trials is not None:
            self.lrs = rng.choice(traffic["lr_grid"], self.trials).astype(
                np.float32)
            self.rates = {f: rng.choice(traffic["dropout_grid"], self.trials
                                        ).astype(np.float32)
                          for f in m.TrialRates._fields}
            self.opt = m.adam_trials_init(self.params)
            self._lrs = torch.as_tensor(self.lrs, device=device)
            self._rates = m.TrialRates(**{
                f: torch.as_tensor(v, device=device)
                for f, v in self.rates.items()})
        else:
            self.opt = m.adam(self.params, self.cfg.learning_rate)
        n_pos = data.train.num_msg // 2
        n_neg = len(data.train.pred) // 2
        self.batch = min(len(data.val.y), n_pos, n_neg)
        pos, neg = _schedule(np.random.default_rng(b_seed),
                             traffic["schedule_epochs"], n_pos, n_neg,
                             self.batch)
        self.pos_np, self.neg_np = pos, neg
        self.pos = torch.as_tensor(pos, dtype=torch.long, device=device)
        self.neg = torch.as_tensor(neg, dtype=torch.long, device=device)
        self.val_y = torch.as_tensor(data.val.y, device=device)
        self.feat = torch.as_tensor(data.node_deg, dtype=torch.long,
                                    device=device)
        shape = (self.trials,) if self.trials is not None else ()
        self.best = (m.tree_map(lambda p: p.detach().clone(), self.params),
                     torch.full(shape, -1.0, device=device))
        self.cursor = 0
        self.chunk_epochs = traffic["chunk_epochs"]
        self.snapshot = self._checked_steps()
        self.chunk()  # warm the window's chunk

    def _call(self, lo: int, hi: int) -> tuple:
        """The window's call on epochs [lo, hi) of the schedule: (losses,
        val AUCs) of each epoch, on the card."""
        m, b = self.m, self.built
        pos, neg = self.pos[lo:hi], self.neg[lo:hi]
        if self.trials is not None:
            best_params, best_auc, (losses, aucs) = m.train_loop_trials(
                self.params, self.opt, self.generator, pos, neg, b["trn"],
                b["val"], self.val_y, self.feat, self.cfg, self._lrs,
                b["num_nodes"], self._rates, init_best=self.best)
        else:
            best_params, best_auc, _, (losses, aucs) = m.train_loop(
                self.params, self.opt, self.generator, pos, neg, b["trn"],
                b["val"], self.val_y, self.feat, self.cfg, b["num_nodes"],
                early_stop=None, init_best=self.best)
        self.best = (best_params, best_auc)
        return losses, aucs

    def _host(self, tree) -> list:
        return [t.detach().to("cpu", copy=True) for t in
                self.m.tree_leaves(tree)]

    def _first_moments(self) -> list:
        """Adam's first moment of each leaf after one step, `(1 - beta1) g`
        (zero where the step left no state)."""
        m = self.m
        if self.trials is not None:
            return m.tree_leaves(self.opt.mu)
        return [self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                for p in m.tree_leaves(self.params)]

    def _checked_steps(self) -> dict:
        """The first three epochs, one a call of the window's own call:
        each epoch's loss and val AUC, the first gradient from the
        optimizer's state, the parameters and best-val parameters after."""
        snap = {"start": self._host(self.params), "loss": [], "val_auc": []}
        for k in range(CHECKED_STEPS):
            losses, aucs = self._call(k, k + 1)
            snap["loss"].append(losses[0].detach().cpu())
            snap["val_auc"].append(aucs[0].detach().cpu())
            if k == 0:
                snap["grad"] = [(t / (1 - ADAM_B1)).detach().cpu()
                                for t in self._first_moments()]
        snap["params"] = self._host(self.params)
        snap["best"] = self._host(self.best[0])
        self.cursor = CHECKED_STEPS
        return snap

    def chunk(self) -> int:
        """One window call of `chunk_epochs` epochs; returns the epochs."""
        return self.run_steps(self.chunk_epochs)

    def run_steps(self, steps: int) -> int:
        """`steps` epochs in one window call, the schedule cycled past the
        checked epochs; returns the epochs."""
        if self.cursor + steps > self.pos.shape[0]:
            self.cursor = CHECKED_STEPS
        self._call(self.cursor, self.cursor + steps)
        self.cursor += steps
        return steps

    def rates_of(self, steps: int, seconds: float) -> dict:
        """The window's rate: trial-epochs a second for trial-major
        trials, epochs a second for one trial."""
        if self.trials is None:
            return {"epochs_per_s": steps / seconds}
        return {"trial_epochs_per_s": steps * self.trials / seconds}

    # -- what the traced run reads ------------------------------------

    def reference_data(self) -> dict:
        """The reference's own splits and structures from the edge file,
        with the program's train negatives (`ref.check_negatives`)."""
        edges, num_nodes = ref.load_edges(DATA_DIR / "fb-pages-food.edges")
        return ref.build_data(edges, num_nodes,
                              self.built["data"].train.pred[0::2],
                              self.config["data_seed"])

    def ops(self) -> list:
        """The step's K3 and K1 calls at this cell's operands, with the
        yardstick's work from the reference's own structures: per epoch the
        train step's degree pass, `depth2` forward and `depth2` transposed
        2-WL gather-sums and `depth1` 1-WL aggregations, and the val
        forward's degree pass, gather-sums and aggregations."""
        from linkpred_tpu_torch.ops import hopper_kernels as hk

        rd = self.reference_data()
        model = self.config["model"]
        t = self.trials or 1
        w2 = t * 2 * model["channels_2wl"]
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
            x = torch.randn((arrays.num_rows, w2), device=dev)
            ops.append({"kernel": "k3", "what": f"{name} degree pass",
                        "fn": lambda x=ones, k=fwd.k3: hk.spmm_bucketed(x, *k),
                        "calls": 1, **work.aggregation_work(a ^ 1, r, 1,
                                                            "f32")})
            ops.append({"kernel": "k3", "what": f"{name} 2-WL forward",
                        "fn": lambda x=x, k=fwd.k3: hk.spmm_bucketed(x, *k),
                        "calls": model["depth2"],
                        **work.aggregation_work(a ^ 1, r, w2, "f32")})
            if name == "train":
                ops.append({"kernel": "k3", "what": "train 2-WL transposed",
                            "fn": lambda x=x, k=bwd.k3: hk.spmm_bucketed(
                                x, *k),
                            "calls": model["depth2"],
                            **work.aggregation_work(b, r, w2, "f32")})
            for i in range(model["depth1"]):
                f = t * dims[i + 1]
                msgs = torch.randn((n_msg, f), device=dev)
                ops.append({"kernel": "k1", "what": f"{name} 1-WL F={f}",
                            "fn": lambda x=msgs, s=arrays: hk.spmm_ell(
                                s.msg_slots, s.msg_sweight, x),
                            "calls": 1,
                            **work.aggregation_work(np.arange(n_msg), n, f,
                                                    "f32")})
        return ops

    def flops_per_step(self) -> tuple[int, str]:
        rd = self.reference_data()
        model = self.config["model"]
        n_msg = len(rd["msg"])
        return work.twowl_epoch_flops(
            self.built["num_nodes"], n_msg,
            n_msg + len(rd["train"]["pred"]), len(rd["train"]["ei2"]),
            n_msg + len(rd["val"]["pred"]), len(rd["val"]["ei2"]),
            2 * self.batch, len(rd["val"]["y"]), model["channels_1wl"],
            model["channels_2wl"], model["depth1"], model["depth2"],
            self.trials or 1), "f32"

    # -- the check ------------------------------------------------------

    def release(self) -> None:
        """Free the program's state on the card before the reference."""
        for name in ("params", "opt", "best", "generator", "pos", "neg",
                     "val_y", "feat", "_lrs", "_rates"):
            if hasattr(self, name):
                delattr(self, name)
        self.built.pop("trn", None)
        self.built.pop("val", None)


def build_faults(built: dict, rd: dict) -> int:
    """Structural faults of the program's host build against the
    reference's: message and prediction edges, the ei2 pairs (as sets of
    live slots), the node degree feature, and the train negatives' own
    soundness."""
    data = built["data"]
    faults = ref.check_negatives(rd["split"], data.train.pred[0::2],
                                 built["num_nodes"])

    def differ(a, b) -> int:
        a, b = np.asarray(a), np.asarray(b)
        return int(a.shape != b.shape or not np.array_equal(a, b))

    faults += differ(data.train.msg, rd["msg"])
    faults += differ(data.val.msg, rd["msg"])
    faults += differ(data.val.pred, rd["val"]["pred"])
    faults += differ(data.node_deg, rd["node_deg"])
    for s, name in ((data.train, "train"), (data.val, "val")):
        mine = np.stack([s.e1_src[s.e1_mask], s.e1_dst[s.e1_mask]], axis=1)
        theirs = rd[name]["ei2"]
        faults += differ(np.unique(mine, axis=0), np.unique(theirs, axis=0))
        faults += int(len(mine) != len(theirs))
    return faults


def readings(run: Run, control_precision: str | None = None) -> dict:
    """The numbers of `check` for this run: the program's first three
    epochs (or, with `control_precision`, the reference's at that
    precision put in the program's place) against the reference's at the
    configuration's precision."""
    precision = run.config["model"]["dtype"]
    rd = run.reference_data()
    model = dict(run.config["model"])
    batches = [(run.pos_np[k], run.neg_np[k]) for k in range(CHECKED_STEPS)]
    start = run.snapshot["start"]
    params0 = ref.tree_like(run.layout, start)
    kwargs = dict(trials=run.trials, device=run.device)
    if run.trials is not None:
        kwargs.update(lrs=run.lrs, rates=run.rates)
    truth = ref.train_steps(params0, model, rd, batches, run.dropout_seed,
                            precision=precision, **kwargs)
    if control_precision is None:
        prog = dict(run.snapshot)
    else:
        prog = ref.train_steps(params0, model, rd, batches, run.dropout_seed,
                               precision=control_precision, **kwargs)
        prog["start"] = start
    axes = ref.leaf_axes(run.layout) if run.trials is not None else None
    out = check.twowl_readings(prog, {**truth, "start": start}, axes)
    out["build"] = build_faults(run.built, rd)
    return out


def start(built: dict, config: dict, traffic: dict, seed: int, device) -> Run:
    return Run(built, config, traffic, seed, device)
