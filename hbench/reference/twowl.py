"""Plain reference of the 2-WL edge GNN (LocalWLNet; Hu et al.,
arXiv:2206.09567) on fb-pages-food: its data, its masked training step and
its validation, for one trial or T trials at once.

Data (`build_data`): the split of the edge file as the dataset's split is
made (upper-triangular dedup, one permutation of a numpy generator for the
85/5/10 positive split, a second over the dense non-edge mask for the
val/test negatives), each undirected pair doubled into two directed edges
2k (u->v) and 2k+1 (v->u), and the ei2 edge-pair structure: for every node
n, every message edge a into n paired with every edge b (message or
prediction) out of n. The train negatives are drawn by the program's
sampler, whose generator this module cannot replay: `check_negatives`
holds them to what they have to be, and the reference then uses them.

Model (`forward`): degree embedding and GraphNorm; `depth1` GCN layers over
the message edges (PyG `gcn_norm` with self loops, degrees counting only the
edges left in the message graph); the edge Hadamard product of the
endpoints' features over every row (message ++ prediction edges); `depth2`
2-WL layers, each the sum over two directions of a GCN convolution over the
ei2 slots whose message edge a is still in the graph — direction 1 from row
a^1 into row b, direction 2 from row a into row b^1 — with its own weights,
GraphNorm, dropout and ReLU; the pair head on the product of a pair's two
rows. Dropout masks are drawn from the run's generator in the model's
order: embedding, each 1-WL layer, then each 2-WL layer's two directions.
Each aggregation here is `index_add_` over an edge list.

Training (`train_steps`): per epoch the sampled positive pairs leave the
message graph, BCE with logits over positives then negatives, Adam, and
the val split scored with the full message graph; each trial keeps its
best-val parameters (a strict improvement). Trial-major parameters carry the
trial axis first, the embedding table's second (`[D+1, T, C]`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from hbench.reference.precision import matmul

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
GN_EPS = 1e-5


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def load_edges(path: Path) -> tuple[np.ndarray, int]:
    edges = np.loadtxt(path, delimiter=",", dtype=np.int64).reshape(-1, 2)
    return edges, int(edges.max()) + 1


def dedup_upper(pairs: np.ndarray) -> np.ndarray:
    """Each undirected pair once as (lo, hi), in order of first appearance,
    self loops dropped."""
    keep = pairs[:, 0] != pairs[:, 1]
    lo = np.minimum(pairs[keep, 0], pairs[keep, 1])
    hi = np.maximum(pairs[keep, 0], pairs[keep, 1])
    n = int(max(lo.max(initial=0), hi.max(initial=0))) + 1
    _, first = np.unique(lo * n + hi, return_index=True)
    first.sort()
    return np.stack([lo[first], hi[first]], axis=1)


def split_positives(edges: np.ndarray, num_nodes: int, seed: int = 0,
                    val_ratio: float = 0.05, test_ratio: float = 0.1) -> dict:
    """The positive split and the val/test negatives; the train negatives
    are the sampler's (`check_negatives`)."""
    rng = np.random.default_rng(seed)
    up = dedup_upper(edges)
    m = len(up)
    n_v, n_t = int(np.floor(val_ratio * m)), int(np.floor(test_ratio * m))
    shuffled = up[rng.permutation(m)]
    non_edge = np.triu(np.ones((num_nodes, num_nodes), dtype=bool), k=1)
    non_edge[up[:, 0], up[:, 1]] = False
    rows, cols = np.nonzero(non_edge)
    pick = rng.permutation(len(rows))[: n_v + n_t]
    negs = np.stack([rows[pick], cols[pick]], axis=1)
    return {"all": up, "val_pos": shuffled[:n_v],
            "test_pos": shuffled[n_v:n_v + n_t],
            "train_pos": shuffled[n_v + n_t:], "val_neg": negs[:n_v],
            "test_neg": negs[n_v:]}


def check_negatives(split: dict, train_neg: np.ndarray,
                    num_nodes: int) -> int:
    """How many ways the train negatives fail to be a uniform sample's
    support: a count other than the train positives', a pair not (lo < hi),
    a repeated pair, a pair that is an edge or a val/test negative. 0 when
    they are sound."""
    neg = np.asarray(train_neg, np.int64)
    faults = int(len(neg) != len(split["train_pos"]))
    faults += int(np.sum(~(neg[:, 0] < neg[:, 1])))
    key = neg[:, 0] * num_nodes + neg[:, 1]
    faults += len(key) - len(np.unique(key))
    taken = np.concatenate([split["all"], split["val_neg"],
                            split["test_neg"]])
    faults += int(np.isin(key, taken[:, 0] * num_nodes + taken[:, 1]).sum())
    return faults


def double(pairs: np.ndarray) -> np.ndarray:
    out = np.empty((2 * len(pairs), 2), dtype=np.int64)
    out[0::2] = pairs
    out[1::2] = pairs[:, ::-1]
    return out


def edge_pairs(num_nodes: int, msg: np.ndarray, pred: np.ndarray
               ) -> np.ndarray:
    """ei2: [S, 2] (a, b), a a message edge into node n and b any edge
    (message ++ prediction) out of n, over every node n."""
    every = np.concatenate([msg, pred])
    into = [[] for _ in range(num_nodes)]
    out_of = [[] for _ in range(num_nodes)]
    for a, dst in enumerate(msg[:, 1]):
        into[dst].append(a)
    for b, src in enumerate(every[:, 0]):
        out_of[src].append(b)
    parts = [np.stack(np.meshgrid(into[n], out_of[n], indexing="ij"),
                      axis=-1).reshape(-1, 2)
             for n in range(num_nodes) if into[n] and out_of[n]]
    return np.concatenate(parts).astype(np.int64)


def build_data(edges: np.ndarray, num_nodes: int, train_neg: np.ndarray,
               seed: int = 0) -> dict:
    """The train and val splits of the reference (host numpy): message and
    prediction edges, ei2, the val labels, the node degree feature."""
    split = split_positives(edges, num_nodes, seed)
    msg = double(split["train_pos"])
    pred_train = double(np.asarray(train_neg, np.int64))
    pred_val = np.concatenate([double(split["val_pos"]),
                               double(split["val_neg"])])
    n_v = len(split["val_pos"])
    return {
        "split": split,
        "num_nodes": num_nodes,
        "msg": msg,
        "train": {"pred": pred_train,
                  "ei2": edge_pairs(num_nodes, msg, pred_train)},
        "val": {"pred": pred_val,
                "ei2": edge_pairs(num_nodes, msg, pred_val),
                "y": np.concatenate([np.ones(n_v), np.zeros(n_v)])},
        "node_deg": np.bincount(msg[:, 1], minlength=num_nodes),
    }


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def _device_split(data: dict, name: str, device) -> dict:
    msg = data["msg"]
    rows = np.concatenate([msg, data[name]["pred"]])
    ei2 = data[name]["ei2"]

    def long(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)

    return {"msg_src": long(msg[:, 0]), "msg_dst": long(msg[:, 1]),
            "row_src": long(rows[:, 0]), "row_dst": long(rows[:, 1]),
            "slot_a": long(ei2[:, 0]), "slot_b": long(ei2[:, 1]),
            "num_msg": len(msg), "num_rows": len(rows)}


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def graph_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=0, keepdim=True)
    centered = x - p["mean_scale"] * mean
    var = (centered * centered).mean(dim=0, keepdim=True)
    return p["weight"] * centered * torch.rsqrt(var + GN_EPS) + p["bias"]


def _lin(x: torch.Tensor, w: torch.Tensor, trials: bool,
         precision: str) -> torch.Tensor:
    """x [R, (T,) C] times w [(T,) C, D]."""
    if trials:
        return matmul(x.transpose(0, 1), w, precision).transpose(0, 1)
    return matmul(x, w, precision)


def _gcn(p: dict, x: torch.Tensor, src, dst, live, num_rows: int,
         trials: bool, precision: str) -> torch.Tensor:
    """GCN convolution over the edges (src -> dst) weighted by `live`
    (1 or 0): `D^-1/2 (A + I) D^-1/2 (x W) + b`, degrees from the live
    edges."""
    deg = torch.ones(num_rows, device=x.device).index_add_(0, dst, live)
    dinv = torch.rsqrt(deg)
    coeff = dinv[src] * dinv[dst] * live
    h = _lin(x, p["w"], trials, precision)
    agg = torch.zeros_like(h).index_add_(0, dst, _col(coeff, h) * h[src])
    return agg + _col(dinv * dinv, h) * h + p["b"]


class Dropout:
    """The model's dropout masks, drawn in order from `generator`: for T
    trials at each trial's rate (`rates` [T]), else at the one `rate` of
    each call (a rate of 0 draws nothing)."""

    def __init__(self, generator, rates: dict | None):
        self.generator, self.rates = generator, rates

    def __call__(self, x: torch.Tensor, key: str, rate: float):
        if self.rates is not None:
            keep_p = (1.0 - self.rates[key])[:, None]
        elif rate <= 0.0:
            return x
        else:
            keep_p = 1.0 - rate
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_p
        return torch.where(keep, x / keep_p, 0.0)


def forward(params: dict, model: dict, deg: torch.Tensor, s: dict,
            msg_mask: torch.Tensor, sel: torch.Tensor, trials: bool,
            drop: Dropout | None = None, precision: str = "f32"
            ) -> torch.Tensor:
    """Logits of the selected pairs: [P] (or [P, T])."""

    def dropped(x, key):
        return x if drop is None else drop(x, key, model[key])

    n = deg.shape[0]
    x = graph_norm(params["emb_gn"], params["emb"][deg])
    x = dropped(x, "dp_emb")
    live = msg_mask.float()
    depth1 = len(params["conv1"])
    for i, layer in enumerate(params["conv1"]):
        x = _gcn(layer, x, s["msg_src"], s["msg_dst"], live, n, trials,
                 precision)
        x = graph_norm(layer["gn"], x)
        last = i == depth1 - 1
        x = dropped(x, "dp_1wl1" if last else "dp_1wl0")
        if model["act1"] if last else model["act0"]:
            x = torch.relu(x)

    e = x[s["row_src"]] * x[s["row_dst"]]
    r = s["num_rows"]
    a, b = s["slot_a"], s["slot_b"]
    slot_live = msg_mask[a].float()
    directions = ((a ^ 1, b), (a, b ^ 1))
    for la, lb in zip(params["conv2"], params["conv2r"]):
        out = []
        for layer, (src, dst) in zip((la, lb), directions):
            h = _gcn(layer, e, src, dst, slot_live, r, trials, precision)
            out.append(graph_norm(layer["gn"], h))
        out = [dropped(h, "dp_2wl") for h in out]
        e = torch.relu(out[0]) + torch.relu(out[1])

    pick = e[sel]
    pair = pick[0::2] * pick[1::2]
    if trials:
        logits = matmul(pair.transpose(0, 1), params["pred_w"],
                        precision).transpose(0, 1)[..., 0]
        return logits + params["pred_b"][:, 0]
    return (matmul(pair, params["pred_w"], precision) + params["pred_b"])[:, 0]


def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean BCE with logits over dim 0: softplus(x) - x y, whose gradient
    sigmoid(x) - y holds at x = 0 too (a pair whose rows are all zero
    scores exactly 0 at the start)."""
    return (F.softplus(logits) - logits * _col(y, logits)).mean(dim=0)


def auc(y: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """AUC of each score column (ties count a half), float64: [T] or []."""
    s = scores.double()
    pos, neg = s[y == 1], s[y == 0]
    greater = (pos[:, None] > neg[None, :]).double()
    ties = (pos[:, None] == neg[None, :]).double()
    return (greater + 0.5 * ties).mean(dim=(0, 1))


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(t, it) for t in tree]
    return next(it)


def tree_like(tree, flat: list):
    return _rebuild(tree, iter(flat))


def leaf_axes(params: dict) -> list:
    """The trial axis of each leaf of trial-major parameters."""
    return [1 if k == "emb" else 0 for k in params
            for _ in leaves(params[k])]


def train_steps(params0: dict, model: dict, data: dict, batches: list,
                dropout_seed: int, device, trials: int | None,
                lrs: np.ndarray | None = None, rates: dict | None = None,
                precision: str = "f32") -> dict:
    """`len(batches)` epochs from `params0` (host tensors): each a masked
    train step on (positive ids, negative ids), Adam, the val split scored.

    For trial-major parameters (`trials` = T) Adam runs per trial at `lrs`
    [T] with dropout at `rates` {field: [T]}; for one trial (`trials`
    None) at `model["lr"]` with `model`'s rates. Returns host copies: each
    epoch's loss, val AUC and parameters after it (`by_epoch`), the first
    step's gradient, the parameters and the best-val parameters after the
    last epoch, and the best val AUC."""
    t = trials is not None
    trn = _device_split(data, "train", device)
    val = _device_split(data, "val", device)
    flat0 = [p.to(device=device, dtype=torch.float32) for p in leaves(params0)]
    params = [p.clone().requires_grad_() for p in flat0]
    best = [p.clone() for p in flat0]
    shape = (trials,) if t else ()
    best_auc = torch.full(shape, -1.0, dtype=torch.float64, device=device)
    mu = [torch.zeros_like(p) for p in flat0]
    nu = [torch.zeros_like(p) for p in flat0]
    axes = leaf_axes(params0) if t else None
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    drop = Dropout(gen, None if not t else {
        k: torch.as_tensor(v, dtype=torch.float32, device=device)
        for k, v in rates.items()})
    lr = (torch.as_tensor(lrs, dtype=torch.float32, device=device) if t
          else model["lr"])
    n = data["num_nodes"]
    num_msg = trn["num_msg"]
    val_sel = torch.arange(val["num_msg"], val["num_rows"], device=device)
    val_y = torch.as_tensor(data["val"]["y"], device=device)
    deg_val = torch.as_tensor(data["node_deg"], dtype=torch.long,
                              device=device)
    out = {"loss": [], "val_auc": [], "by_epoch": []}
    for k, (pos, neg) in enumerate(batches):
        pos = torch.as_tensor(np.asarray(pos), dtype=torch.long, device=device)
        neg = torch.as_tensor(np.asarray(neg), dtype=torch.long, device=device)
        removed = torch.zeros(num_msg, dtype=torch.bool, device=device)
        removed[2 * pos] = True
        removed[2 * pos + 1] = True
        msg_mask = ~removed
        deg = torch.zeros(n, device=device).index_add_(
            0, trn["msg_dst"], msg_mask.float()).long()
        sel = torch.cat([torch.stack([2 * pos, 2 * pos + 1], 1).reshape(-1),
                         num_msg + torch.stack([2 * neg, 2 * neg + 1],
                                               1).reshape(-1)])
        y = torch.cat([torch.ones(len(pos), device=device),
                       torch.zeros(len(neg), device=device)])
        tree = tree_like(params0, params)
        logits = forward(tree, model, deg, trn, msg_mask, sel, t, drop,
                         precision)
        loss = _bce(logits, y)
        grads = torch.autograd.grad(loss.sum(), params)
        if k == 0:
            out["grad"] = [g.detach().cpu() for g in grads]
        c = k + 1
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                mu[i].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                nu[i].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                step = (mu[i] / (1 - ADAM_B1 ** c)) / (
                    torch.sqrt(nu[i] / (1 - ADAM_B2 ** c)) + ADAM_EPS)
                if t:
                    view = [1] * p.dim()
                    view[axes[i]] = trials
                    step = step * lr.view(view)
                else:
                    step = step * lr
                p.sub_(step)
            tree = tree_like(params0, params)
            scores = forward(tree, model, deg_val, val,
                             torch.ones(val["num_msg"], dtype=torch.bool,
                                        device=device), val_sel, t)
            val_auc = auc(val_y, scores)
            better = val_auc > best_auc
            for i, p in enumerate(params):
                if t:
                    view = [1] * p.dim()
                    view[axes[i]] = trials
                    pick = better.view(view)
                else:
                    pick = better
                best[i] = torch.where(pick, p, best[i])
            best_auc = torch.where(better, val_auc, best_auc)
        out["loss"].append(loss.detach().cpu())
        out["val_auc"].append(val_auc.cpu())
        out["by_epoch"].append([p.detach().to("cpu", copy=True)
                                for p in params])
    out["params"] = out["by_epoch"][-1]
    out["best"] = [p.cpu() for p in best]
    out["best_auc"] = best_auc.cpu()
    return out
