"""LocalWLNet, the 2-WL edge-level GNN — the counterpart of
`linkpred_tpu/models/twowl.py` in PyTorch.

Parameters are a nested dict of tensors with the reference's pytree layout
(`emb`, `emb_gn`, `conv1`, `conv2`, `conv2r`, `pred_w`, `pred_b`), so
`params_from_jax` maps the JAX parameters leaf for leaf. The forward is the
reference's: degree embedding + GraphNorm, `depth1` GCN layers over the
message graph (aggregated by the bucketed plan or by kernel K1), the edge
Hadamard product, `depth2` paired 2-WL layers over the ei2 structure (both
directions in one composed gather), and the pair-product head.

Not ported yet: the unpaired 2-WL branch (the reference takes it only
without `e1_cops`, which `from_split` always builds), `compute_dtype='bf16'`
and the trial-major sweep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from linkpred_tpu_torch.ops.sddmm import edge_hadamard
from linkpred_tpu_torch.ops.segment import (
    SegmentPlan,
    composed_operands,
    gather_sum_composed,
    gcn_norm_coefficients,
    segment_sum,
    segment_sum_ell,
    segment_sum_planned,
)
from linkpred_tpu_torch.utils.metrics import roc_auc


@dataclasses.dataclass(frozen=True)
class TwoWLConfig:
    """Hyperparameters; defaults are the reference's published best trial
    (lr 0.01, depths 2/2, channels 24/16, dropouts .5/.2/.4/.1, act0 true,
    act1 false). `agg_1wl` picks the 1-WL aggregation: 'plan' (bucketed
    gathers, plain PyTorch) or 'ell' (kernel K1 via `segment_sum_ell`)."""

    max_degree: int
    channels_1wl: int = 24
    channels_2wl: int = 16
    depth1: int = 2
    depth2: int = 2
    dp_emb: float = 0.5
    dp_1wl0: float = 0.2
    dp_1wl1: float = 0.4
    dp_2wl: float = 0.1
    act0: bool = True
    act1: bool = False
    learning_rate: float = 0.01
    eps: float = 1e-5
    # True: degree-indexed embedding table (the reference default); False:
    # one free embedding row per node (callers set max_degree = N - 1)
    degree_feature: bool = True
    compute_dtype: str = "f32"
    agg_1wl: str = "plan"

    def __post_init__(self):
        if self.agg_1wl not in ("plan", "ell"):
            raise ValueError(f"agg_1wl must be 'plan' or 'ell', got "
                             f"{self.agg_1wl!r}")
        if self.compute_dtype == "bf16":
            raise NotImplementedError(
                "compute_dtype='bf16' is not ported yet")
        if self.compute_dtype != "f32":
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """Apply `fn` leaf-wise over nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def _glorot(gen, shape):
    lim = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * lim


def _gn_params(dim):
    return {"weight": torch.ones(dim), "bias": torch.zeros(dim),
            "mean_scale": torch.ones(dim)}


def _conv(gen, d_in, d_out):
    return {"w": _glorot(gen, (d_in, d_out)), "b": torch.zeros(d_out),
            "gn": _gn_params(d_out)}


def init_params(cfg: TwoWLConfig, generator: torch.Generator, device) -> dict:
    """Reference-layout parameters, drawn on the host from a CPU
    `generator` (so a seed gives the same init on every device), as leaf
    tensors on `device` that require grad."""
    params = {
        "emb": torch.randn((cfg.max_degree + 1, cfg.channels_1wl),
                           generator=generator),
        "emb_gn": _gn_params(cfg.channels_1wl),
    }
    dims = [cfg.channels_1wl] * cfg.depth1 + [cfg.channels_2wl]
    params["conv1"] = [_conv(generator, dims[i], dims[i + 1])
                       for i in range(cfg.depth1)]
    C2 = cfg.channels_2wl
    params["conv2"] = [_conv(generator, C2, C2) for _ in range(cfg.depth2)]
    params["conv2r"] = [_conv(generator, C2, C2) for _ in range(cfg.depth2)]
    params["pred_w"] = _glorot(generator, (C2, 1))
    params["pred_b"] = torch.zeros(1)
    return tree_map(lambda t: t.to(device).requires_grad_(), params)


def params_from_jax(tree_of_numpy, device) -> dict:
    """The JAX package's parameter pytree (leaves as numpy arrays, e.g.
    `jax.tree_util.tree_map(np.asarray, params)`) as this module's
    parameters on `device`: same keys, same lists, leaf for leaf."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device).requires_grad_(),
        tree_of_numpy)


def adam(params: dict, learning_rate: float) -> torch.optim.Adam:
    """Adam over every leaf; with eps 1e-8 and no weight decay it is the
    update of optax's `adam(learning_rate)` that the reference uses."""
    return torch.optim.Adam(tree_leaves(params), lr=learning_rate, eps=1e-8)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def graph_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """PyG GraphNorm over all rows, with population variance in f32."""
    x32 = x.float()
    mean = x32.mean(dim=0, keepdim=True)
    centered = x32 - p["mean_scale"] * mean
    var = (centered * centered).mean(dim=0, keepdim=True)
    out = p["weight"] * centered * torch.rsqrt(var + eps) + p["bias"]
    return out.to(x.dtype)


def gcn_conv(p: dict, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             num_rows: int, mask: torch.Tensor | None = None,
             norm: tuple | None = None, plan: tuple | None = None,
             ell: tuple | None = None) -> torch.Tensor:
    """PyG-style GCNConv: h = xW; out[t] = sum_e norm_e h[src_e] + self
    loop + b. `norm` is a precomputed (edge_coeff, self_coeff) pair; `plan`
    the `SegmentPlan.operands` of `dst`; `ell` the plan's
    `ell_operands`, which routes the aggregation through kernel K1."""
    h = x @ p["w"]
    coeff, self_coeff = norm if norm is not None else gcn_norm_coefficients(
        src, dst, num_rows, mask, plan=plan)
    msgs = h[src] * coeff[:, None]
    if ell is not None:
        agg = segment_sum_ell(num_rows, msgs, plan[0], *ell)
    elif plan is not None:
        agg = segment_sum_planned(msgs, *plan)
    else:
        agg = segment_sum(msgs, dst, num_rows)
    return agg + self_coeff[:, None] * h + p["b"]


@dataclasses.dataclass(frozen=True)
class SplitArrays:
    """Device-resident static arrays of one TwoWL split (see
    `linkpred_tpu.data.twowl.TwoWLSplit`). Indices used by PyTorch indexing
    are int64; K1's slot matrix is int32, converted once here."""

    msg_src_s: torch.Tensor  # [Em] message sources in dst-sorted order
    msg_dst_s: torch.Tensor  # [Em] sorted message destinations
    msg_perm: torch.Tensor  # [Em] argsort(msg dst)
    pos1_src: torch.Tensor  # [R]
    pos1_dst: torch.Tensor  # [R]
    msg_plan: tuple  # SegmentPlan.operands of the sorted message dst
    msg_slots: torch.Tensor  # [N, W] int32, K1 slot matrix
    msg_sweight: torch.Tensor  # [N, W] float32, 1 on valid slots
    # direction-1 composed structures (fwd_ops, bwd_ops); direction 2 rides
    # the same gather through the parity pairing in `forward`
    e1_cops: tuple

    @property
    def num_msg(self) -> int:
        return self.msg_perm.shape[0]

    @property
    def num_rows(self) -> int:
        return self.pos1_src.shape[0]

    @staticmethod
    def from_split(s, device) -> "SplitArrays":
        R = len(s.pos1)
        msg_plan = SegmentPlan.build(s.msg[s.msg_perm][:, 1], s.num_nodes)
        e1_plan = SegmentPlan.build(s.e1_dst, R)
        # dir-1 slot (a, b) gathers row a^1; pads carry R, the zero row
        src1 = np.where(s.e1_mask, s.e1_src ^ 1, R)
        e1_gather_plan = SegmentPlan.build(src1, R)
        e1_cops = (
            composed_operands(e1_plan, src1, R, device),
            composed_operands(e1_gather_plan,
                              np.where(s.e1_mask, s.e1_dst, R), R, device),
        )
        slots, sweight = msg_plan.ell_operands(device)

        def long(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=device)

        return SplitArrays(
            msg_src_s=long(s.msg[s.msg_perm, 0]),
            msg_dst_s=long(s.msg[s.msg_perm, 1]),
            msg_perm=long(s.msg_perm),
            pos1_src=long(s.pos1[:, 0]),
            pos1_dst=long(s.pos1[:, 1]),
            msg_plan=msg_plan.operands(device),
            msg_slots=slots,
            msg_sweight=sweight,
            e1_cops=e1_cops,
        )


def _dropout(generator, x, rate):
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (
        1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _swap(v: torch.Tensor) -> torch.Tensor:
    """Parity-partner row view: row r <-> row r ^ 1 (R is even)."""
    return v.reshape(-1, 2, *v.shape[1:]).flip(1).reshape(v.shape)


def forward(params: dict, cfg: TwoWLConfig, node_deg: torch.Tensor,
            arrays: SplitArrays, msg_mask: torch.Tensor,
            sel_idx: torch.Tensor,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """One logit per undirected selected pair: [B // 2].

    `node_deg` [N] int64 degree feature, `msg_mask` [Em] bool in original
    edge order (False on removed positives), `sel_idx` [B] doubled row ids
    into pos1. `generator` (on the device of the tensors) turns on dropout;
    None is eval mode.
    """
    train = generator is not None

    def drop(x, rate):
        return _dropout(generator, x, rate) if train else x

    N = node_deg.shape[0]
    R = arrays.num_rows

    x = params["emb"][node_deg]
    x = graph_norm(params["emb_gn"], x, cfg.eps)
    x = drop(x, cfg.dp_emb)

    mask_s = msg_mask[arrays.msg_perm]
    norm1 = gcn_norm_coefficients(arrays.msg_src_s, arrays.msg_dst_s, N,
                                  mask_s, plan=arrays.msg_plan)
    ell = ((arrays.msg_slots, arrays.msg_sweight)
           if cfg.agg_1wl == "ell" else None)
    for i, layer in enumerate(params["conv1"]):
        x = gcn_conv(layer, x, arrays.msg_src_s, arrays.msg_dst_s, N,
                     norm=norm1, plan=arrays.msg_plan, ell=ell)
        x = graph_norm(layer["gn"], x, cfg.eps)
        last = i == cfg.depth1 - 1
        x = drop(x, cfg.dp_1wl1 if last else cfg.dp_1wl0)
        if cfg.act1 if last else cfg.act0:
            x = torch.relu(x)

    e = edge_hadamard(arrays.pos1_src, arrays.pos1_dst, x)

    # PAIRED 2-WL path (the reference's derivation, `forward` in
    # linkpred_tpu/models/twowl.py): the slot coefficient dinv[src] *
    # dinv[dst] * mask factorises into row-wise multiplies, and direction 2
    # enumerates the parity image of direction 1's slots, so packing row r
    # as [hA[r] * mA[r] || hB[r^1] * mB[r^1]] makes ONE 2C-channel
    # composed gather produce both directions.
    num_msg = msg_mask.shape[0]
    C2 = cfg.channels_2wl
    ones_pred = torch.ones(R - num_msg, dtype=torch.float32,
                           device=msg_mask.device)
    rm2 = torch.cat([msg_mask.float(), ones_pred])
    rm1 = _swap(rm2)
    fwd_ops, bwd_ops = arrays.e1_cops
    deg1 = gather_sum_composed(rm1[:, None], fwd_ops, bwd_ops)[:, 0] + 1.0
    dinv1 = torch.rsqrt(deg1.clamp(min=1e-12))
    dinv2 = _swap(dinv1)
    mA = dinv1 * rm1
    mB = _swap(mA)
    outA, outB = dinv1[:, None], dinv2[:, None]
    selfA, selfB = (dinv1 * dinv1)[:, None], (dinv2 * dinv2)[:, None]

    for i in range(cfg.depth2):
        lA, lB = params["conv2"][i], params["conv2r"][i]
        hA = e @ lA["w"]
        hB = e @ lB["w"]
        h2 = torch.cat([hA * mA[:, None], _swap(hB * mB[:, None])], dim=1)
        out = gather_sum_composed(h2, fwd_ops, bwd_ops)
        hA = out[:, :C2] * outA + selfA * hA + lA["b"]
        hB = _swap(out[:, C2:]) * outB + selfB * hB + lB["b"]
        hA = torch.relu(drop(graph_norm(lA["gn"], hA, cfg.eps), cfg.dp_2wl))
        hB = torch.relu(drop(graph_norm(lB["gn"], hB, cfg.eps), cfg.dp_2wl))
        e = hA + hB

    sel = e[sel_idx]
    paired = sel[0::2] * sel[1::2]
    return (paired @ params["pred_w"] + params["pred_b"])[:, 0]


# ---------------------------------------------------------------------------
# sample_block as mask arithmetic + train/eval steps
# ---------------------------------------------------------------------------


def double_index(ids: torch.Tensor) -> torch.Tensor:
    """Pair ids -> interleaved doubled row ids [2P]."""
    return torch.stack([2 * ids, 2 * ids + 1], dim=1).reshape(-1)


def sample_block_masks(pos_ids, num_msg: int, e_src, e_mask):
    """The reference `sample_block` as masks: remove the sampled positive
    pairs' doubled edges from the message graph and mask ei2 columns
    sourced at a removed edge."""
    removed = torch.zeros(num_msg, dtype=torch.bool, device=pos_ids.device)
    removed[double_index(pos_ids)] = True
    return ~removed, e_mask & ~removed[e_src]


def train_step(params: dict, optimizer: torch.optim.Optimizer,
               generator: torch.Generator | None, pos_ids: torch.Tensor,
               neg_ids: torch.Tensor, arrays: SplitArrays, cfg: TwoWLConfig,
               num_nodes: int):
    """One masked minibatch step: remove the sampled positives from the
    message graph, recompute degrees, BCE on pos+neg pairs, Adam. Updates
    `params` in place; returns (loss, logits, labels), detached."""
    device = pos_ids.device
    num_msg = arrays.num_msg
    idx1 = double_index(pos_ids)
    idx2 = double_index(neg_ids) + num_msg
    removed = torch.zeros(num_msg, dtype=torch.bool, device=device)
    removed[idx1] = True
    msg_mask = ~removed
    if cfg.degree_feature:
        deg = segment_sum_planned(
            msg_mask[arrays.msg_perm].float(), *arrays.msg_plan).long()
    else:
        deg = torch.arange(num_nodes, device=device)
    sel = torch.cat([idx1, idx2])
    y = torch.cat([torch.ones(pos_ids.shape[0], device=device),
                   torch.zeros(neg_ids.shape[0], device=device)])
    logits = forward(params, cfg, deg, arrays, msg_mask, sel, generator)
    loss = F.binary_cross_entropy_with_logits(logits, y)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach(), logits.detach(), y


def train_loop(params: dict, optimizer: torch.optim.Optimizer,
               generator: torch.Generator | None,
               pos_ids_epochs: torch.Tensor, neg_ids_epochs: torch.Tensor,
               trn: SplitArrays, val: SplitArrays, val_y: torch.Tensor,
               node_deg: torch.Tensor, cfg: TwoWLConfig, num_nodes: int,
               early_stop: int | None = None):
    """The reference's `train_scan` as an epoch loop on the device: per
    epoch a masked train step and a val eval with on-device AUC; the
    best-val parameters are kept by a select, with no host round trip.

    Early stop is epoch-exact: an epoch runs only while epochs-since-best
    <= `early_stop`, and skipped epochs keep the reference's (loss 0,
    auc -1) history markers. The host keeps an upper bound on that counter
    and reads the device value only when the bound passes `early_stop`.

    Returns (best_params, best_val_auc, since_best, (losses [E], aucs [E])).
    """
    device = val_y.device
    E = pos_ids_epochs.shape[0]
    num_msg_v = val.num_msg
    val_sel = num_msg_v + torch.arange(val.num_rows - num_msg_v,
                                       device=device)
    val_msg_mask = torch.ones(num_msg_v, dtype=torch.bool, device=device)

    best_params = tree_map(lambda p: p.detach().clone(), params)
    best_leaves, leaves = tree_leaves(best_params), tree_leaves(params)
    best_auc = torch.zeros((), device=device)
    since = torch.zeros((), dtype=torch.long, device=device)
    losses = torch.zeros(E, device=device)
    aucs = torch.full((E,), -1.0, device=device)
    since_bound = 0  # host-side upper bound on `since`
    for epoch in range(E):
        if early_stop is not None and since_bound > early_stop:
            since_bound = int(since)
            if since_bound > early_stop:
                since = since + (E - epoch)  # the reference counts frozen epochs
                break
        loss, _, _ = train_step(params, optimizer, generator,
                                pos_ids_epochs[epoch], neg_ids_epochs[epoch],
                                trn, cfg, num_nodes)
        with torch.no_grad():
            logits = forward(params, cfg, node_deg, val, val_msg_mask,
                             val_sel)
            auc = roc_auc(val_y, logits)
            improved = auc > best_auc
            for b, p in zip(best_leaves, leaves):
                b.copy_(torch.where(improved, p, b))
            best_auc = torch.where(improved, auc, best_auc)
            since = torch.where(improved, 0, since + 1)
            losses[epoch] = loss
            aucs[epoch] = auc
        since_bound += 1
    return best_params, best_auc, since, (losses, aucs)


@torch.no_grad()
def eval_scores(params: dict, node_deg: torch.Tensor, arrays: SplitArrays,
                cfg: TwoWLConfig) -> torch.Tensor:
    """Scores for every prediction pair of a split (rows after the message
    block)."""
    device = node_deg.device
    num_msg = arrays.num_msg
    msg_mask = torch.ones(num_msg, dtype=torch.bool, device=device)
    sel = num_msg + torch.arange(arrays.num_rows - num_msg, device=device)
    return torch.sigmoid(forward(params, cfg, node_deg, arrays, msg_mask, sel))
