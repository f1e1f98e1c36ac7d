"""Plain reference of the 2-WL edge GNN at scale (LocalWLNet; Hu et al.,
arXiv:2206.09567) as the port's scale path runs it: a degree-capped graph, a
learnable row per node, the ei2 products capped per node, and the 2-WL stack
at a stated precision.

Data (`build_data`), from the generated edge list (data, as weights are: the
benchmark's driver passes the synthetic generator's pairs):

- the degree cap: the distinct undirected pairs (lo < hi), sorted; each node
  whose count of kept pairs exceeds the cap, in increasing id, drops a
  uniform subset of them so that `cap` are left: the first `count - cap` of
  one permutation of its kept pairs, listed with the node as the lower end
  and then as the higher end, each by pair order, drawn from
  `np.random.default_rng(seed)`. A dropped pair lowers both ends' counts;
- the split: the kept pairs shuffled by one permutation of the same
  generator; the first floor(val_ratio m) are val positives, the next
  floor(test_ratio m) test positives, the rest train positives, each
  doubled into edges 2k (u->v) and 2k+1 (v->u);
- the ei2 products: for every node n, each message edge a into n with each
  edge b (message ++ prediction) out of n. A node with at most `ei2_cap`
  products keeps them all, and this module enumerates them itself; a node
  with more keeps `ei2_cap` of them, drawn uniformly.

**Departures.** The program draws three things from its generator after a
sampler whose stream this module cannot replay (the negatives are drawn by
rejection, at 50,000 nodes in the port's C++ plane): the val and test
negatives, the train negatives, and the products kept at each node over the
ei2 cap. So `build_data` takes the program's draws (`drawn`), counts each
way they fail to be what their rule makes them (`faults`: a count, pair
order, a repeat or an edge where a uniform sample of non-edges has none; a
product that is not the node's, a repeat, or another count than the cap at a
capped node, other products at an uncapped one) and then uses them. The
initial parameters are the program's: the node table's start is a node2vec
run (walks and SGNS) of the program's; `node2vec` below is what that run
is held against.

Model (`forward`): the node table and GraphNorm; `depth1` GCN layers over
the message edges in f32 (`twowl._gcn`); the edge Hadamard product of the
endpoints' rows; `depth2` 2-WL layers, each the sum over two directions of a
GCN convolution over the ei2 slots whose message edge is still in the graph
(direction 1 from row a^1 into row b, direction 2 from row a into row b^1);
the pair head on the product of a pair's two rows. Dropout is off at scale.
Each aggregation is `index_add_` over an edge list.

Precision (`rounder`): "f32" computes as written. "bf16" rounds to bfloat16,
values in the forward and gradients in the backward, each tensor the port's
bf16 2-WL stack stores: the edge rows, the 2-WL weights and biases, the
normalisation factors, each elementwise product and sum, each matmul's
output, the aggregated sums, the GraphNorm outputs and the pair products;
GraphNorm's statistics, the sums inside a matmul or an aggregation and
everything outside the stack stay f32. "e4m3" rounds the same tensors to
float8 e4m3's 3 mantissa bits at f32's exponent range (so nothing overflows
or flushes to zero: only the precision is lower): the control. A second
part after a slash sets the parts outside the stack, for the controls of
their precision: "bf16/tf32" runs their matmuls at TF32, "bf16/bf16" rounds
the node table, the 1-WL weights and outputs, the GraphNorm outputs and the
head to bfloat16.

Node2vec (`node2vec`): the reference's own table from walks and SGNS over
its message graph, at a seed of its own, against which the driver holds
the program's table (`table_auc` and the rows' norms).
"""

from __future__ import annotations

import numpy as np
import torch

from hbench.reference import twowl as ref
from hbench.reference.precision import matmul

# explicit mantissa bits of each precision the 2-WL stack is rounded to
MANTISSA_BITS = {"bf16": 7, "e4m3": 3}


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """f32 -> the nearest value with `bits` explicit mantissa bits, ties to
    even, as f32 (bfloat16's rounding at `bits` = 7)."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    odd = (i >> drop) & 1
    rounded = (i + ((1 << (drop - 1)) - 1) + odd) & ~((1 << drop) - 1)
    return rounded.view(torch.float32)


class _Round(torch.autograd.Function):
    """A tensor stored at lower precision: its value rounded forward, the
    gradient that reaches it rounded backward."""

    @staticmethod
    def forward(ctx, x, bits):
        ctx.bits = bits
        return round_mantissa(x, bits)

    @staticmethod
    def backward(ctx, g):
        return round_mantissa(g, ctx.bits), None


def rounder(precision: str):
    """The rounding of a stored 2-WL tensor at `precision`."""
    if precision == "f32":
        return lambda x: x
    bits = MANTISSA_BITS[precision]
    return lambda x: _Round.apply(x, bits)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def distinct_pairs(lo: np.ndarray, hi: np.ndarray,
                   num_nodes: int) -> np.ndarray:
    """Each undirected pair once as (lo, hi), sorted, self loops dropped."""
    lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
    keep = lo != hi
    a, b = np.minimum(lo[keep], hi[keep]), np.maximum(lo[keep], hi[keep])
    key = np.unique(a * num_nodes + b)
    return np.stack([key // num_nodes, key % num_nodes], axis=1)


def degree_cap(pairs: np.ndarray, num_nodes: int, cap: int,
               rng: np.random.Generator) -> np.ndarray:
    """The pairs left after the degree cap (module docstring), in order."""
    m = len(pairs)
    ends = np.concatenate([pairs[:, 0], pairs[:, 1]])
    incident = np.tile(np.arange(m), 2)[np.argsort(ends, kind="stable")]
    count = np.bincount(ends, minlength=num_nodes)
    start = np.concatenate([[0], np.cumsum(count)])
    kept = np.ones(m, dtype=bool)
    left = count.copy()
    for v in np.flatnonzero(count > cap):
        if left[v] <= cap:
            continue
        mine = incident[start[v]:start[v + 1]]
        alive = mine[kept[mine]]
        dropped = alive[rng.permutation(len(alive))[:len(alive) - cap]]
        kept[dropped] = False
        np.subtract.at(left, pairs[dropped].reshape(-1), 1)
    return pairs[kept]


def split_pairs(pairs: np.ndarray, rng: np.random.Generator,
                val_ratio: float, test_ratio: float) -> dict:
    m = len(pairs)
    n_v, n_t = int(np.floor(val_ratio * m)), int(np.floor(test_ratio * m))
    shuffled = pairs[rng.permutation(m)]
    return {"all": pairs, "val_pos": shuffled[:n_v],
            "test_pos": shuffled[n_v:n_v + n_t],
            "train_pos": shuffled[n_v + n_t:]}


def held_out_negative_faults(split: dict, num_nodes: int) -> int:
    """How many ways the val and test negatives fail to be a uniform
    sample's support: counts other than their positives', a pair not
    (lo < hi), a pair repeated across both, a pair that is an edge."""
    val, test = split["val_neg"], split["test_neg"]
    neg = np.concatenate([val, test]).astype(np.int64)
    faults = int(len(val) != len(split["val_pos"]))
    faults += int(len(test) != len(split["test_pos"]))
    faults += int(np.sum(~(neg[:, 0] < neg[:, 1])))
    key = neg[:, 0] * num_nodes + neg[:, 1]
    faults += len(key) - len(np.unique(key))
    edges = split["all"][:, 0] * num_nodes + split["all"][:, 1]
    return faults + int(np.isin(key, edges).sum())


def _groups(keys: np.ndarray, num_nodes: int) -> list:
    """Indices of `keys` by value, each group in index order."""
    order = np.argsort(keys, kind="stable")
    return np.split(order, np.cumsum(np.bincount(keys, minlength=num_nodes))
                    [:-1])


def capped_edge_pairs(num_nodes: int, msg: np.ndarray, pred: np.ndarray,
                      cap: int, drawn: np.ndarray) -> tuple[np.ndarray, int]:
    """(ei2 [S, 2], faults): every product of each node with at most `cap`,
    enumerated here, and the program's `drawn` products at each node with
    more, held to being `cap` distinct products of that node; a drawn set
    that differs from this module's at an uncapped node counts too."""
    every = np.concatenate([msg, pred])
    into = _groups(msg[:, 1], num_nodes)
    out_of = _groups(every[:, 0], num_nodes)
    products = np.array([len(i) * len(o) for i, o in zip(into, out_of)])
    whole = products <= cap
    own = [np.stack(np.meshgrid(into[n], out_of[n], indexing="ij"),
                    axis=-1).reshape(-1, 2)
           for n in np.flatnonzero(whole & (products > 0))]
    own = (np.concatenate(own) if own else np.zeros((0, 2), np.int64))

    drawn = np.asarray(drawn, np.int64).reshape(-1, 2)
    a, b = drawn[:, 0], drawn[:, 1]
    inside = (a >= 0) & (a < len(msg)) & (b >= 0) & (b < len(every))
    faults = int(np.sum(~inside))
    drawn, a, b = drawn[inside], a[inside], b[inside]
    node = msg[a, 1]
    faults += int(np.sum(node != every[b, 0]))
    key = a * len(every) + b
    faults += len(key) - len(np.unique(key))
    faults += int(np.sum(np.bincount(node, minlength=num_nodes)
                         != np.minimum(products, cap)))
    mine = np.sort(own[:, 0] * len(every) + own[:, 1])
    faults += int(not np.array_equal(mine, np.sort(key[whole[node]])))
    return np.concatenate([own, drawn[~whole[node]]]), faults


def build_data(lo: np.ndarray, hi: np.ndarray, num_nodes: int,
               max_degree: int, ei2_cap: int, val_ratio: float,
               test_ratio: float, seed: int, drawn: dict) -> dict:
    """The train and val splits of the reference (host numpy), from the
    generated pairs (`lo`, `hi`) and the program's draws that this module
    cannot replay: `drawn` holds `val_neg`, `test_neg`, `train_neg` ([P, 2]
    undirected pairs) and `ei2` ({"train", "val"}: [S, 2] products). Also
    `faults`, the draws' count of faults (module docstring)."""
    rng = np.random.default_rng(seed)
    pairs = degree_cap(distinct_pairs(lo, hi, num_nodes), num_nodes,
                       max_degree, rng)
    split = split_pairs(pairs, rng, val_ratio, test_ratio)
    split["val_neg"] = np.asarray(drawn["val_neg"], np.int64)
    split["test_neg"] = np.asarray(drawn["test_neg"], np.int64)
    faults = held_out_negative_faults(split, num_nodes)
    faults += ref.check_negatives(split, drawn["train_neg"], num_nodes)
    msg = ref.double(split["train_pos"])
    n_v = len(split["val_pos"])
    preds = {"train": ref.double(np.asarray(drawn["train_neg"], np.int64)),
             "val": np.concatenate([ref.double(split["val_pos"]),
                                    ref.double(split["val_neg"])])}
    out = {"split": split, "num_nodes": num_nodes, "msg": msg}
    for name, pred in preds.items():
        ei2, bad = capped_edge_pairs(num_nodes, msg, pred, ei2_cap,
                                     drawn["ei2"][name])
        out[name] = {"pred": pred, "ei2": ei2}
        faults += bad
    out["val"]["y"] = np.concatenate([np.ones(n_v), np.zeros(n_v)])
    out["faults"] = faults
    return out


# ---------------------------------------------------------------------------
# node2vec
# ---------------------------------------------------------------------------


def node2vec(msg: np.ndarray, num_nodes: int, walks_per_node: int,
             walk_length: int, epochs: int, dim: int, window: int, seed: int,
             device, negatives: int = 5, lr: float = 0.025,
             min_lr: float = 1e-4, batch: int = 65536) -> torch.Tensor:
    """A node table [num_nodes, dim] f32 on `device` from the message edges
    `msg` ([E, 2], each undirected edge both ways): node2vec at p = q = 1
    and word2vec's skip-gram with negative sampling, as written in the two
    papers (Grover and Leskovec 2016; Mikolov et al. 2013).

    - walks: `walks_per_node` walks of `walk_length` from every node, each
      step to a uniform neighbour; a walk that reaches a node without one
      ends there;
    - pairs: a token of a walk and one at an offset within a window drawn
      uniformly in [1, `window`] (word2vec's reduced window), the offset
      uniform within it, either side;
    - SGD, batch-synchronous over `batch` such pairs (at most 16 a node),
      each with `negatives` noise nodes drawn by the walks' token counts to
      the 3/4; the rate falls linearly from `lr` to `min_lr` over
      `epochs * tokens * (window + 1) / batch` steps (word2vec trains about
      `window + 1` pairs a token an epoch);
    - the input table starts uniform in [-0.5, 0.5) / dim, the output table
      at zero; the input table is returned.

    All draws come from one generator seeded `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    src = torch.as_tensor(msg[:, 0], dtype=torch.long, device=device)
    dst = torch.as_tensor(msg[:, 1], dtype=torch.long, device=device)
    order = torch.argsort(src, stable=True)
    nbr = dst[order]
    deg = torch.bincount(src, minlength=num_nodes)
    first = torch.cumsum(deg, 0) - deg

    cur = torch.arange(num_nodes, device=device).repeat(walks_per_node)
    steps = [cur]
    for _ in range(walk_length - 1):
        at = cur.clamp(min=0)
        d = deg[at]
        pick = first[at] + (torch.rand(len(cur), generator=gen,
                                       device=device) * d).long()
        ok = (cur >= 0) & (d > 0)
        cur = torch.where(ok, nbr[pick.clamp(max=max(len(nbr) - 1, 0))], -1)
        steps.append(cur)
    walks = torch.stack(steps, 1)  # [W, L], -1 past a walk's end

    tokens = walks[walks >= 0]
    noise = torch.bincount(tokens, minlength=num_nodes).double() ** 0.75
    batch = max(1, min(batch, 16 * num_nodes))
    n_steps = max(1, int(epochs * len(tokens) * (window + 1) / batch))
    w_in = (torch.rand((num_nodes, dim), generator=gen, device=device)
            - 0.5) / dim
    w_out = torch.zeros((num_nodes, dim), device=device)
    n_walks, length = walks.shape
    for rate in np.linspace(lr, min_lr, n_steps).tolist():
        w = torch.randint(0, n_walks, (batch,), generator=gen, device=device)
        t = torch.randint(0, length, (batch,), generator=gen, device=device)
        reach = torch.randint(1, window + 1, (batch,), generator=gen,
                              device=device)
        off = (torch.rand(batch, generator=gen, device=device)
               * reach).long() + 1
        side = torch.randint(0, 2, (batch,), generator=gen,
                             device=device) * 2 - 1
        u = t + side * off
        inside = (u >= 0) & (u < length)
        c, o = walks[w, t], walks[w, u.clamp(0, length - 1)]
        valid = (inside & (c >= 0) & (o >= 0)).float()
        c, o = c.clamp(min=0), o.clamp(min=0)
        neg = torch.multinomial(noise, batch * negatives, replacement=True,
                                generator=gen).view(batch, negatives)
        vc, uo, un = w_in[c], w_out[o], w_out[neg]
        g_pos = (torch.sigmoid((vc * uo).sum(1)) - 1) * valid  # [B]
        g_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", vc, un)) \
            * valid[:, None]  # [B, K]
        grad_vc = g_pos[:, None] * uo + torch.einsum("bk,bkd->bd", g_neg, un)
        w_in.index_add_(0, c, -rate * grad_vc)
        w_out.index_add_(0, o, -rate * g_pos[:, None] * vc)
        w_out.index_add_(0, neg.reshape(-1),
                         -rate * (g_neg[:, :, None] * vc[:, None, :])
                         .reshape(-1, dim))
    return w_in


def table_auc(table: torch.Tensor, pos: np.ndarray,
              neg: np.ndarray) -> float:
    """The AUC of a node table's row dot products on positive and negative
    pairs ([P, 2] each): how well the table alone predicts the links. By
    ranks (Mann-Whitney), ties at their mean rank."""
    t = table.detach().double().cpu()

    def score(pairs):
        pairs = torch.as_tensor(np.asarray(pairs), dtype=torch.long)
        return (t[pairs[:, 0]] * t[pairs[:, 1]]).sum(1)

    s = torch.cat([score(pos), score(neg)])
    _, inverse, counts = torch.unique(s, return_inverse=True,
                                      return_counts=True)
    last = torch.cumsum(counts, 0).double()
    ranks = ((last - counts + 1 + last) / 2)[inverse]
    p, n = len(pos), len(neg)
    return float((ranks[:p].sum() - p * (p + 1) / 2) / (p * n))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def _gcn_2wl(p: dict, x: torch.Tensor, src, dst, live, num_rows: int,
             r) -> torch.Tensor:
    """A 2-WL direction's GCN convolution, `D^-1/2 (A + I) D^-1/2 (x W) + b`
    with degrees from the live slots, rounded by `r` where the port's stack
    stores a tensor: the source factor, each message, the sum, each term."""
    deg = torch.ones(num_rows, device=x.device).index_add_(0, dst, live)
    dinv = torch.rsqrt(deg)
    h = r(x @ r(p["w"]))
    msgs = r(h[src] * r(dinv[src] * live)[:, None])
    agg = r(torch.zeros_like(h).index_add_(0, dst, msgs))
    out = r(r(agg * r(dinv)[:, None]) + r(r(dinv * dinv)[:, None] * h))
    return r(out + r(p["b"]))


def parts(precision: str) -> tuple:
    """(the 2-WL stack's precision, the other parts') of a precision
    "<stack>" or "<stack>/<rest>"; the rest is "f32" unless named."""
    stack, _, rest = precision.partition("/")
    return stack, rest or "f32"


def forward(params: dict, model: dict, s: dict, msg_mask: torch.Tensor,
            sel: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """Logits [P] of the selected pairs (`sel`: doubled row ids)."""
    stack, rest = parts(precision)
    r = rounder(stack)
    # the parts outside the 2-WL stack: "f32" as written, "tf32" their
    # matmuls at TF32, "bf16" their weights, outputs and the node table
    # rounded to bfloat16 (a control: the port runs them in f32)
    q = rounder("bf16") if rest == "bf16" else rounder("f32")
    mm = "tf32" if rest == "tf32" else "f32"
    x = q(ref.graph_norm(params["emb_gn"], q(params["emb"])))
    n = x.shape[0]
    live = msg_mask.float()
    depth1 = len(params["conv1"])
    for i, layer in enumerate(params["conv1"]):
        x = q(ref._gcn({**layer, "w": q(layer["w"])}, x, s["msg_src"],
                       s["msg_dst"], live, n, False, mm))
        x = q(ref.graph_norm(layer["gn"], x))
        last = i == depth1 - 1
        if model["act1"] if last else model["act0"]:
            x = torch.relu(x)

    e = r(x[s["row_src"]] * x[s["row_dst"]])
    a, b = s["slot_a"], s["slot_b"]
    slot_live = msg_mask[a].float()
    for la, lb in zip(params["conv2"], params["conv2r"]):
        out = [r(ref.graph_norm(layer["gn"], _gcn_2wl(
                   layer, e, src, dst, slot_live, s["num_rows"], r)))
               for layer, (src, dst) in zip((la, lb),
                                            ((a ^ 1, b), (a, b ^ 1)))]
        e = r(torch.relu(out[0]) + torch.relu(out[1]))
    pick = e[sel]
    pair = q(r(pick[0::2] * pick[1::2]))
    return q(matmul(pair, q(params["pred_w"]), mm) + params["pred_b"])[:, 0]


def train_steps(params0: dict, model: dict, data: dict, batches: list,
                device, precision: str = "f32") -> dict:
    """`len(batches)` epochs from `params0` (host tensors) at `model["lr"]`:
    each a masked train step on (positive ids, negative ids), Adam, and the
    val split scored, the best-val parameters kept (a strict improvement).
    Returns host copies: each epoch's loss, val AUC and parameters after it
    (`by_epoch`), the first step's gradient, the parameters and best-val
    parameters after the last epoch, and the best val AUC."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trn = ref._device_split(data, "train", device)
    val = ref._device_split(data, "val", device)
    flat0 = [p.to(device=device, dtype=torch.float32)
             for p in ref.leaves(params0)]
    params = [p.clone().requires_grad_() for p in flat0]
    best = [p.clone() for p in flat0]
    best_auc = torch.tensor(-1.0, dtype=torch.float64, device=device)
    mu = [torch.zeros_like(p) for p in flat0]
    nu = [torch.zeros_like(p) for p in flat0]
    num_msg, lr = trn["num_msg"], model["lr"]
    val_sel = torch.arange(val["num_msg"], val["num_rows"], device=device)
    val_y = torch.as_tensor(data["val"]["y"], device=device)
    whole = torch.ones(val["num_msg"], dtype=torch.bool, device=device)
    out = {"loss": [], "val_auc": [], "by_epoch": []}
    for k, (pos, neg) in enumerate(batches):
        pos = torch.as_tensor(np.asarray(pos), dtype=torch.long, device=device)
        neg = torch.as_tensor(np.asarray(neg), dtype=torch.long, device=device)
        msg_mask = torch.ones(num_msg, dtype=torch.bool, device=device)
        msg_mask[2 * pos] = False
        msg_mask[2 * pos + 1] = False
        sel = torch.cat([torch.stack([2 * pos, 2 * pos + 1], 1).reshape(-1),
                         num_msg + torch.stack([2 * neg, 2 * neg + 1],
                                               1).reshape(-1)])
        y = torch.cat([torch.ones(len(pos), device=device),
                       torch.zeros(len(neg), device=device)])
        logits = forward(ref.tree_like(params0, params), model, trn,
                         msg_mask, sel, precision)
        loss = ref._bce(logits, y)
        grads = torch.autograd.grad(loss, params)
        if k == 0:
            out["grad"] = [g.detach().cpu() for g in grads]
        c = k + 1
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                mu[i].mul_(ref.ADAM_B1).add_(g, alpha=1 - ref.ADAM_B1)
                nu[i].mul_(ref.ADAM_B2).addcmul_(g, g, value=1 - ref.ADAM_B2)
                p.sub_(lr * (mu[i] / (1 - ref.ADAM_B1 ** c)) / (
                    torch.sqrt(nu[i] / (1 - ref.ADAM_B2 ** c))
                    + ref.ADAM_EPS))
            scores = forward(ref.tree_like(params0, params), model, val,
                             whole, val_sel, precision)
            val_auc = ref.auc(val_y, scores)
            better = val_auc > best_auc
            best = [torch.where(better, p, q) for p, q in zip(params, best)]
            best_auc = torch.where(better, val_auc, best_auc)
        out["loss"].append(loss.detach().cpu())
        out["val_auc"].append(val_auc.cpu())
        out["by_epoch"].append([p.detach().to("cpu", copy=True)
                                for p in params])
    out["params"] = out["by_epoch"][-1]
    out["best"] = [p.cpu() for p in best]
    out["best_auc"] = best_auc.cpu()
    return out
