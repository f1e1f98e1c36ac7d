"""LocalWLNet, the 2-WL edge-level GNN — the counterpart of
`linkpred_tpu/models/twowl.py` in PyTorch.

Parameters are a nested dict of tensors with the reference's pytree layout
(`emb`, `emb_gn`, `conv1`, `conv2`, `conv2r`, `pred_w`, `pred_b`), so
`params_from_jax` maps the JAX parameters leaf for leaf. The forward is the
reference's: degree embedding + GraphNorm, `depth1` GCN layers over the
message graph (aggregated by the bucketed plan or by kernel K1), the edge
Hadamard product, `depth2` paired 2-WL layers over the ei2 structure (both
directions in one composed gather-sum, plain or on kernel K3), and the
pair-product head.

The trial-major section trains T (lr x dropout) trials at once, as the
reference's sweep does: features are `[rows, T, C]`, so each gather and
both aggregations serve all T trials in one call (K1 on `[S, T*C]`, K3 on
`[R, T*2C]`), with a per-trial Adam written on tensors.

`compute_dtype='bf16'` runs the 2-WL stack of the single-trial `forward` in
bfloat16 (the 1-WL stack, the normalisation factors' arithmetic and every
GraphNorm statistic stay f32). The unpaired 2-WL branch, one planned
segment sum per direction, is taken for `SplitArrays.from_split(...,
paired=False)`; it is the semantic check of the paired path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from linkpred_tpu_torch.ops.gather import gather_rows
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
from linkpred_tpu_torch.utils.metrics import roc_auc, roc_auc_trials
from linkpred_tpu_torch.utils.profiling import mark_step, span


@dataclasses.dataclass(frozen=True)
class TwoWLConfig:
    """Hyperparameters; defaults are the reference's published best trial
    (lr 0.01, depths 2/2, channels 24/16, dropouts .5/.2/.4/.1, act0 true,
    act1 false). `agg_1wl` picks both aggregations: 'plan' runs them in
    plain PyTorch (bucketed gathers); 'ell' runs the 1-WL aggregation on
    kernel K1 (`segment_sum_ell`) and the paired 2-WL composed gather-sum,
    forward and backward, on kernel K3 (`gather_sum_composed(...,
    kernel=True)`). The name is the reference's field."""

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
        if self.compute_dtype not in ("f32", "bf16"):
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


def _draw_params(cfg: TwoWLConfig, generator: torch.Generator) -> dict:
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
    return params


def init_params(cfg: TwoWLConfig, generator: torch.Generator, device) -> dict:
    """Reference-layout parameters, drawn on the host from a CPU
    `generator` (so a seed gives the same init on every device), as leaf
    tensors on `device` that require grad."""
    return tree_map(lambda t: t.to(device).requires_grad_(),
                    _draw_params(cfg, generator))


def params_from_jax(tree_of_numpy, device) -> dict:
    """The JAX package's parameter pytree (leaves as numpy arrays, e.g.
    `jax.tree_util.tree_map(np.asarray, params)`) as this module's
    parameters on `device`: same keys, same lists, leaf for leaf, in the
    layout given. A trial-major pytree (the reference's
    `init_params_trials`) maps onto `init_params_trials`'s layout."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device).requires_grad_(),
        tree_of_numpy)


def adam(params: dict, learning_rate: float) -> torch.optim.Adam:
    """Adam over every leaf; with eps 1e-8 and no weight decay it is the
    update of optax's `adam(learning_rate)` that the reference uses."""
    return torch.optim.Adam(tree_leaves(params), lr=learning_rate, eps=1e-8)


def warmup_cosine_schedule(init_value: float, peak_value: float,
                           warmup_steps: int, decay_steps: int,
                           end_value: float = 0.0):
    """optax's `warmup_cosine_decay_schedule` as a function of the step
    (an int or an integer array) -> learning rate, float64: linear from
    `init_value` to `peak_value` over `warmup_steps`, then a cosine from
    `peak_value` to `end_value` that ends at step `decay_steps`. optax's
    Adam reads its schedule at its own count, which starts at 0: step k
    of a run (0-based) trains at `schedule(k)`."""
    cosine_steps = decay_steps - warmup_steps
    if warmup_steps < 0 or cosine_steps <= 0:
        raise ValueError("warmup_cosine_schedule needs 0 <= warmup_steps < "
                         f"decay_steps, got {warmup_steps}, {decay_steps}")
    alpha = end_value / peak_value

    def schedule(step):
        step = np.asarray(step, dtype=np.float64)
        if warmup_steps > 0:
            frac = 1.0 - np.clip(step, 0, warmup_steps) / warmup_steps
            warm = (init_value - peak_value) * frac + peak_value
        else:
            warm = np.full_like(step, peak_value)
        count = np.clip(step - warmup_steps, 0, cosine_steps)
        cosine = 0.5 * (1.0 + np.cos(np.pi * count / cosine_steps))
        decayed = peak_value * ((1.0 - alpha) * cosine + alpha)
        return np.where(step < warmup_steps, warm, decayed)

    return schedule


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
    h = x @ p["w"].to(x.dtype)
    coeff, self_coeff = norm if norm is not None else gcn_norm_coefficients(
        src, dst, num_rows, mask, plan=plan)
    # coefficients and bias follow the feature dtype: an f32 operand would
    # promote a bf16 2-WL stack back to f32
    msgs = gather_rows(h, src) * coeff.to(h.dtype)[:, None]
    if ell is not None:
        agg = segment_sum_ell(num_rows, msgs, plan[0], *ell)
    elif plan is not None:
        agg = segment_sum_planned(msgs, *plan)
    else:
        agg = segment_sum(msgs, dst, num_rows)
    return agg + self_coeff.to(h.dtype)[:, None] * h + p["b"].to(h.dtype)


@dataclasses.dataclass(frozen=True)
class SplitArrays:
    """Device-resident static arrays of one TwoWL split (see
    `linkpred_tpu_torch.data.twowl.TwoWLSplit`). Indices used by PyTorch indexing
    are int64; K1's slot matrix and K3's composed layout are int32,
    converted once here."""

    msg_src_s: torch.Tensor  # [Em] message sources in dst-sorted order
    msg_dst_s: torch.Tensor  # [Em] sorted message destinations
    msg_perm: torch.Tensor  # [Em] argsort(msg dst)
    pos1_src: torch.Tensor  # [R]
    pos1_dst: torch.Tensor  # [R]
    msg_plan: tuple  # SegmentPlan.operands of the sorted message dst
    msg_slots: torch.Tensor  # [N, W] int32, K1 slot matrix
    msg_sweight: torch.Tensor  # [N, W] float32, 1 on valid slots
    # direction-1 composed structures (fwd_ops, bwd_ops), each a
    # `ComposedOps`; direction 2 rides the same gather through the parity
    # pairing in `forward`. Empty for `paired=False`
    e1_cops: tuple
    # the unpaired branch's structures, only for `paired=False`: per
    # direction the slots' message-edge id, sorted destination row (pads =
    # R) and validity, and the `SegmentPlan.operands` of the destinations
    e1_src: torch.Tensor | None = None  # [S]; dir-1 source row = e1_src ^ 1
    e1_dst: torch.Tensor | None = None
    e1_mask: torch.Tensor | None = None
    e2_src: torch.Tensor | None = None  # [S]; dir-2 source row
    e2_dst: torch.Tensor | None = None
    e2_mask: torch.Tensor | None = None
    e1_plan: tuple = ()
    e2_plan: tuple = ()
    # the paired 2-WL aggregation, `(x, fwd_ops, bwd_ops, kernel) -> [R,
    # C]` over e1_cops; a split of a slice of the slots gets one that
    # completes the partial sum (`parallel.dp.shard_twowl_split`)
    paired_sum: Callable = gather_sum_composed

    @property
    def num_msg(self) -> int:
        return self.msg_perm.shape[0]

    @property
    def num_rows(self) -> int:
        return self.pos1_src.shape[0]

    @staticmethod
    def from_split(s, device, paired: bool = True) -> "SplitArrays":
        """The split's arrays on `device`. `paired` (the default, and what
        every pipeline runs) builds the composed operands of the paired 2-WL
        path; `paired=False` leaves them empty and uploads the two
        directions' slot arrays and destination plans instead, so that
        `forward` takes the unpaired branch."""
        R = len(s.pos1)
        msg_plan = SegmentPlan.build(s.msg[s.msg_perm][:, 1], s.num_nodes)
        e1_plan = SegmentPlan.build(s.e1_dst, R)
        slots, sweight = msg_plan.ell_operands(device)

        def long(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=device)

        if paired:
            # dir-1 slot (a, b) gathers row a^1; pads carry R, the zero row
            src1 = np.where(s.e1_mask, s.e1_src ^ 1, R)
            e1_gather_plan = SegmentPlan.build(src1, R)
            two_wl = dict(e1_cops=(
                composed_operands(e1_plan, src1, R, device),
                composed_operands(e1_gather_plan,
                                  np.where(s.e1_mask, s.e1_dst, R), R, device),
            ))
        else:
            two_wl = dict(
                e1_cops=(),
                e1_src=long(s.e1_src), e1_dst=long(s.e1_dst),
                e1_mask=torch.as_tensor(s.e1_mask, device=device),
                e2_src=long(s.e2_src), e2_dst=long(s.e2_dst),
                e2_mask=torch.as_tensor(s.e2_mask, device=device),
                e1_plan=e1_plan.operands(device),
                e2_plan=SegmentPlan.build(s.e2_dst, R).operands(device),
            )

        return SplitArrays(
            msg_src_s=long(s.msg[s.msg_perm, 0]),
            msg_dst_s=long(s.msg[s.msg_perm, 1]),
            msg_perm=long(s.msg_perm),
            pos1_src=long(s.pos1[:, 0]),
            pos1_dst=long(s.pos1[:, 1]),
            msg_plan=msg_plan.operands(device),
            msg_slots=slots,
            msg_sweight=sweight,
            **two_wl,
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


def _paired_norm(arrays: SplitArrays, msg_mask: torch.Tensor,
                 kernel: bool) -> tuple:
    """Row factors of the paired 2-WL GCN normalisation (see `forward`),
    each [R]: dinv of direction 1 and of direction 2, and the masked input
    factors mA, mB of the two directions."""
    R = arrays.num_rows
    ones_pred = torch.ones(R - msg_mask.shape[0], dtype=torch.float32,
                           device=msg_mask.device)
    rm1 = _swap(torch.cat([msg_mask.float(), ones_pred]))
    deg1 = arrays.paired_sum(rm1[:, None], *arrays.e1_cops,
                              kernel)[:, 0] + 1.0
    dinv1 = torch.rsqrt(deg1.clamp(min=1e-12))
    mA = dinv1 * rm1
    return dinv1, _swap(dinv1), mA, _swap(mA)


def _unpaired_norms(arrays: SplitArrays, msg_mask: torch.Tensor) -> tuple:
    """Per direction of the unpaired 2-WL path (`from_split(...,
    paired=False)`): (source rows [S], the GCN normalisation (slot coeff
    [S], self coeff [R]) under `msg_mask`, the destination plan). A slot is
    live while its message edge is; a pad's destination R is clamped for
    the coefficient gather and its coefficient is masked to 0."""
    R = arrays.num_rows
    out = []
    for src_row, e_src, e_dst, e_mask, plan in (
            (arrays.e1_src ^ 1, arrays.e1_src, arrays.e1_dst, arrays.e1_mask,
             arrays.e1_plan),
            (arrays.e2_src, arrays.e2_src, arrays.e2_dst, arrays.e2_mask,
             arrays.e2_plan)):
        live = e_mask & msg_mask[e_src]
        norm = gcn_norm_coefficients(src_row, e_dst.clamp(max=R - 1), R, live,
                                     plan=plan)
        out.append((src_row, norm, plan))
    return tuple(out)


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
    kernel = cfg.agg_1wl == "ell"

    x = gather_rows(params["emb"], node_deg)
    x = graph_norm(params["emb_gn"], x, cfg.eps)
    x = drop(x, cfg.dp_emb)

    mask_s = msg_mask[arrays.msg_perm]
    norm1 = gcn_norm_coefficients(arrays.msg_src_s, arrays.msg_dst_s, N,
                                  mask_s, plan=arrays.msg_plan)
    ell = (arrays.msg_slots, arrays.msg_sweight) if kernel else None
    for i, layer in enumerate(params["conv1"]):
        x = gcn_conv(layer, x, arrays.msg_src_s, arrays.msg_dst_s, N,
                     norm=norm1, plan=arrays.msg_plan, ell=ell)
        x = graph_norm(layer["gn"], x, cfg.eps)
        last = i == cfg.depth1 - 1
        x = drop(x, cfg.dp_1wl1 if last else cfg.dp_1wl0)
        if cfg.act1 if last else cfg.act0:
            x = torch.relu(x)

    # the edge rows in the 2-WL compute dtype: everything below runs over
    # the S-slot ei2 structure, where bf16 halves every gathered byte
    cd = torch.bfloat16 if cfg.compute_dtype == "bf16" else torch.float32
    e = edge_hadamard(arrays.pos1_src, arrays.pos1_dst, x).to(cd)

    if arrays.e1_cops:
        # PAIRED 2-WL path (the reference's derivation, `forward` in
        # linkpred_tpu/models/twowl.py): the slot coefficient dinv[src] *
        # dinv[dst] * mask factorises into row-wise multiplies, and
        # direction 2 enumerates the parity image of direction 1's slots, so
        # packing row r as [hA[r] * mA[r] || hB[r^1] * mB[r^1]] makes ONE
        # 2C-channel composed gather produce both directions. The factors
        # are computed in f32 and cast once.
        C2 = cfg.channels_2wl
        dinv1, dinv2, mA, mB = _paired_norm(arrays, msg_mask, kernel)
        mA, mB = mA.to(cd)[:, None], mB.to(cd)[:, None]
        outA, outB = dinv1.to(cd)[:, None], dinv2.to(cd)[:, None]
        selfA = (dinv1 * dinv1).to(cd)[:, None]
        selfB = (dinv2 * dinv2).to(cd)[:, None]

        for i in range(cfg.depth2):
            lA, lB = params["conv2"][i], params["conv2r"][i]
            hA = e @ lA["w"].to(cd)
            hB = e @ lB["w"].to(cd)
            h2 = torch.cat([hA * mA, _swap(hB * mB)], dim=1)
            out = arrays.paired_sum(h2, *arrays.e1_cops, kernel)
            hA = out[:, :C2] * outA + selfA * hA + lA["b"].to(cd)
            hB = _swap(out[:, C2:]) * outB + selfB * hB + lB["b"].to(cd)
            hA = torch.relu(drop(graph_norm(lA["gn"], hA, cfg.eps),
                                 cfg.dp_2wl))
            hB = torch.relu(drop(graph_norm(lB["gn"], hB, cfg.eps),
                                 cfg.dp_2wl))
            e = hA + hB
    else:
        # UNPAIRED path: one GCN convolution per direction over its own
        # sorted slots, on the plain planned segment sum
        R = arrays.num_rows
        branches = _unpaired_norms(arrays, msg_mask)
        for i in range(cfg.depth2):
            parts = []
            for layer, (src, norm, plan) in zip(
                    (params["conv2"][i], params["conv2r"][i]), branches):
                h = gcn_conv(layer, e, src, None, R, norm=norm, plan=plan)
                h = drop(graph_norm(layer["gn"], h, cfg.eps), cfg.dp_2wl)
                parts.append(torch.relu(h))
            e = parts[0] + parts[1]

    sel = gather_rows(e, sel_idx)
    paired = (sel[0::2] * sel[1::2]).float()
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


def _step_inputs(pos_ids, neg_ids, arrays: SplitArrays, cfg: TwoWLConfig,
                 num_nodes: int) -> tuple:
    """(msg_mask, node features, selected rows, labels) of one masked
    minibatch: the sampled positives leave the message graph and the
    degrees are recomputed without them."""
    device = pos_ids.device
    num_msg = arrays.num_msg
    idx1 = double_index(pos_ids)
    idx2 = double_index(neg_ids) + num_msg
    # a fill by index: `removed[idx1] = True` would copy the host's True to
    # the card, which a CUDA graph's capture refuses
    removed = torch.zeros(num_msg, dtype=torch.bool,
                          device=device).index_fill_(0, idx1, True)
    msg_mask = ~removed
    if cfg.degree_feature:
        deg = segment_sum_planned(
            msg_mask[arrays.msg_perm].float(), *arrays.msg_plan).long()
    else:
        deg = torch.arange(num_nodes, device=device)
    sel = torch.cat([idx1, idx2])
    y = torch.cat([torch.ones(pos_ids.shape[0], device=device),
                   torch.zeros(neg_ids.shape[0], device=device)])
    return msg_mask, deg, sel, y


def train_step(params: dict, optimizer: torch.optim.Optimizer,
               generator: torch.Generator | None, pos_ids: torch.Tensor,
               neg_ids: torch.Tensor, arrays: SplitArrays, cfg: TwoWLConfig,
               num_nodes: int):
    """One masked minibatch step: remove the sampled positives from the
    message graph, recompute degrees, BCE on pos+neg pairs, Adam. Updates
    `params` in place and leaves no gradient; returns (loss, logits,
    labels), detached."""
    with span("twowl.inputs"):
        msg_mask, deg, sel, y = _step_inputs(pos_ids, neg_ids, arrays, cfg,
                                             num_nodes)
    with span("twowl.forward"):
        logits = forward(params, cfg, deg, arrays, msg_mask, sel, generator)
        loss = F.binary_cross_entropy_with_logits(logits, y)
    with span("twowl.backward"):
        loss.backward()
    with span("twowl.optimizer"):
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
    return loss.detach(), logits.detach(), y


def train_loop(params: dict, optimizer: torch.optim.Optimizer,
               generator: torch.Generator | None,
               pos_ids_epochs: torch.Tensor, neg_ids_epochs: torch.Tensor,
               trn: SplitArrays, val: SplitArrays, val_y: torch.Tensor,
               node_deg: torch.Tensor, cfg: TwoWLConfig, num_nodes: int,
               early_stop: int | None = None, eval_every: int = 1,
               init_best: tuple | None = None, lr_schedule=None):
    """The reference's `train_scan` as an epoch loop on the device: per
    epoch a masked train step and a val eval with on-device AUC; the
    best-val parameters are kept by a select, with no host round trip.

    Early stop is epoch-exact: an epoch runs only while epochs-since-best
    <= `early_stop`, and skipped epochs keep the reference's (loss 0,
    auc -1) history markers. The host keeps an upper bound on that counter
    and reads the device value only when the bound passes `early_stop`.

    `eval_every` > 1 scores the val split only on epochs with `epoch %
    eval_every == eval_every - 1` (the epoch counted within this call); the
    others log auc -1 and count as not improved. `init_best` =
    (best_params, best_auc[, since_best]) carries the best of an earlier
    call, so a run can be cut into several calls; its parameters are
    updated in place. `lr_schedule`, a host sequence of this call's
    per-epoch learning rates, is written into the optimizer's param groups
    before each step.

    On the calls that `_graph_path` admits (CUDA tensors, an optimizer that
    can be captured, a val eval every epoch, no schedule, the composed
    paired sum) the epochs after the first of an optimizer are replays of
    one CUDA graph (`_EpochGraph`) of the same epoch, with the same
    arithmetic and the same dropout masks; other calls run every epoch op
    by op. `EPOCH_COUNTS` counts both kinds.

    Each epoch is a `twowl.epoch` span (`utils.profiling`). An epoch run op
    by op holds the train step's phases and the val eval's `twowl.eval`; a
    replayed epoch holds one `twowl.replay`, and the phases open only in
    the `twowl.capture` that records the graph.

    Returns (best_params, best_val_auc, since_best, (losses [E], aucs [E])).
    """
    device = val_y.device
    E = pos_ids_epochs.shape[0]
    graph = None
    if _graph_path(device, optimizer, trn, val, eval_every, lr_schedule):
        graph = _EpochGraph.of(optimizer, device)
    if init_best is None:
        init_best = (tree_map(lambda p: p.detach().clone(), params), 0.0)
    best_params, best_auc_in, since_in = (*init_best, 0)[:3]
    best_leaves, leaves = tree_leaves(best_params), tree_leaves(params)
    # a host-side upper bound on `since`, read from the card only for an
    # early stop: a read waits for the card
    since_bound = int(since_in) if early_stop is not None else 0
    frozen = 0
    losses = torch.zeros(E, device=device)
    aucs = torch.full((E,), -1.0, device=device)

    with contextlib.nullcontext() if graph is None else graph.on_stream():
        if graph is None:
            val_sel, val_msg_mask = _val_rows(val, device)
            best_auc = torch.empty((), dtype=torch.float32, device=device)
            since = torch.empty((), dtype=torch.long, device=device)
        else:
            key = functools.partial(
                _graph_key, optimizer, generator, pos_ids_epochs,
                neg_ids_epochs, trn, val, val_y, node_deg, cfg, num_nodes,
                leaves, best_leaves)
            graph.bind(key(), pos_ids_epochs, neg_ids_epochs, val,
                       (leaves, best_leaves, trn, val, val_y, node_deg))
            val_sel, val_msg_mask = graph.val_sel, graph.val_msg_mask
            best_auc, since = graph.best_auc, graph.since
        best_auc.fill_(best_auc_in)  # a number or a 0-d tensor
        since.fill_(since_in)

        def epoch_fn(pos_ids, neg_ids, evaluate: bool) -> tuple:
            """One epoch's train step and, with `evaluate`, its val eval;
            `best_auc` and `since` are updated in place. (loss, auc or
            None), 0-d."""
            loss, _, _ = train_step(params, optimizer, generator, pos_ids,
                                    neg_ids, trn, cfg, num_nodes)
            with torch.no_grad():
                if not evaluate:
                    since.add_(1)
                    return loss, None
                with span("twowl.eval"):
                    logits = forward(params, cfg, node_deg, val,
                                     val_msg_mask, val_sel)
                    auc = roc_auc(val_y, logits)
                    improved = auc > best_auc
                    for b, p in zip(best_leaves, leaves):
                        b.copy_(torch.where(improved, p, b))
                    torch.where(improved, auc, best_auc, out=best_auc)
                    since.add_(1).masked_fill_(improved, 0)
                return loss, auc

        for epoch in range(E):
            if early_stop is not None and since_bound > early_stop:
                since_bound = int(since)
                if since_bound > early_stop:
                    frozen = E - epoch  # the reference counts frozen epochs
                    break
            with span("twowl.epoch"):
                mark_step(device)
                if lr_schedule is not None:
                    for group in optimizer.param_groups:
                        group["lr"] = float(lr_schedule[epoch])
                if graph is None:
                    loss, auc = epoch_fn(
                        pos_ids_epochs[epoch], neg_ids_epochs[epoch],
                        epoch % eval_every == eval_every - 1)
                    EPOCH_COUNTS["eager"] += 1
                else:
                    loss, auc = graph.step(epoch_fn, pos_ids_epochs[epoch],
                                           neg_ids_epochs[epoch], generator,
                                           key)
                losses[epoch] = loss
                if auc is not None:
                    aucs[epoch] = auc
            since_bound += 1
        mark_step(device, end=True)
        result = best_auc.clone(), since + frozen
    return best_params, *result, (losses, aucs)


def _val_rows(val: SplitArrays, device) -> tuple:
    """(rows scored, message mask) of the val eval: every prediction row,
    over the whole message graph."""
    num_msg = val.num_msg
    return (num_msg + torch.arange(val.num_rows - num_msg, device=device),
            torch.ones(num_msg, dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# the single-trial epoch as one CUDA graph
# ---------------------------------------------------------------------------

# `train_loop`'s epochs in this process by how they ran: "eager", op by op
# from Python, or "replayed", one replay of the epoch's CUDA graph; and the
# graphs captured ("captures"). `hopper_kernels.LAUNCHES` counts the host's
# launches: a graph's kernel launches count there at its capture, not at
# its replays.
EPOCH_COUNTS = {"eager": 0, "replayed": 0, "captures": 0}


def _graph_path(device: torch.device, optimizer: torch.optim.Optimizer,
                trn: SplitArrays, val: SplitArrays, eval_every: int,
                lr_schedule) -> bool:
    """Whether `train_loop` runs its epochs as graph replays, from what the
    call shows: tensors on CUDA; an optimizer whose step can be captured
    (each group has torch's `capturable` option, and it is on or the
    optimizer has not stepped yet, so that `_EpochGraph.of` can turn it
    on); a val eval every epoch and no learning-rate schedule, so that
    every epoch does the same work; and both splits' paired 2-WL sums the
    composed gather-sum (a sharded split's sum completes over ranks,
    `parallel.dp.shard_twowl_split`)."""
    groups = optimizer.param_groups
    return (device.type == "cuda" and lr_schedule is None
            and eval_every == 1
            and trn.paired_sum is gather_sum_composed
            and val.paired_sum is gather_sum_composed
            and all("capturable" in g for g in groups)
            and (not optimizer.state or all(g["capturable"] for g in groups)))


def _signature(obj):
    """What a CUDA graph bakes in of `obj`: each tensor's address, shape,
    strides and dtype, through dataclasses, named tuples, tuples and lists;
    any other value as it is (compared by `==`; a function or a generator
    by identity)."""
    if isinstance(obj, torch.Tensor):
        return (obj.data_ptr(), tuple(obj.shape), obj.stride(), obj.dtype)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return tuple(_signature(getattr(obj, f.name))
                     for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_signature(o) for o in obj)
    return obj


def _graph_key(optimizer: torch.optim.Optimizer,
               generator: torch.Generator | None,
               pos_ids_epochs: torch.Tensor, neg_ids_epochs: torch.Tensor,
               trn: SplitArrays, val: SplitArrays, val_y: torch.Tensor,
               node_deg: torch.Tensor, cfg: TwoWLConfig, num_nodes: int,
               leaves: list, best_leaves: list) -> tuple:
    """`_signature` of all that a `train_loop` call's epoch graph reads or
    writes by address, with the optimizer's hyperparameters and state, the
    dropout generator, `cfg` and `num_nodes`; of the pair ids, whose epoch
    rows are copied into the graph's own buffers, only their shape and
    type."""
    hyper = [tuple((k, _signature(v)) for k, v in sorted(g.items())
                   if k != "params") for g in optimizer.param_groups]
    state = [_signature(v) for p in leaves
             for v in optimizer.state.get(p, {}).values()]
    ids = [(t.shape[1:], t.dtype, t.device)
           for t in (pos_ids_epochs, neg_ids_epochs)]
    return _signature((leaves, best_leaves, state, hyper, trn, val, val_y,
                       node_deg, cfg, num_nodes, generator, ids))


class _EpochGraph:
    """One epoch of the single-trial `train_loop` as a CUDA graph, kept for
    one optimizer as long as it lives (`_GRAPHS`): `_step_inputs`, the
    forward with dropout, the BCE loss and its backward, Adam's step and
    `zero_grad`, the val forward, its AUC and the best-val select. It works
    on static tensors (`bind`): the epoch's pair ids and the best AUC and
    the epochs since it, which the host fills, and the loss and AUC of the
    capture, which each replay writes anew. Parameters, Adam's state and
    the best leaves are updated in place, so their addresses stay.

    Its key (`_graph_key`) changes with any address the graph holds: a
    call with another key gets new static tensors, one epoch op by op and
    a new capture, never a stale replay. The epoch op by op comes first
    because it makes Adam's state and every lazy handle (kernel libraries,
    cuBLAS's workspace) outside the capture; it is real training, as every
    replay is. The generator is registered with the graph, so a replay
    draws the same stream of dropout masks, in the same order, as an epoch
    op by op. All of it runs on the graph's own stream (`on_stream`),
    epochs op by op too, so cuBLAS keeps one workspace."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.key = None
        self.graph = None

    @classmethod
    def of(cls, optimizer: torch.optim.Optimizer,
           device: torch.device) -> "_EpochGraph":
        """The optimizer's graph, made at its first call; an optimizer that
        has not stepped is made `capturable` then, so its step counts and
        bias corrections live on the card (an optimizer run only op by op
        is left as it was made)."""
        graph = _GRAPHS.get(optimizer)
        if graph is None:
            for group in optimizer.param_groups:
                group["capturable"] = True
            graph = _GRAPHS[optimizer] = cls(device)
        return graph

    @contextlib.contextmanager
    def on_stream(self):
        """Run the block on the graph's stream, after the caller's stream's
        work and before its next."""
        caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield
        caller.wait_stream(self.stream)

    def bind(self, key: tuple, pos_ids_epochs: torch.Tensor,
             neg_ids_epochs: torch.Tensor, val: SplitArrays, refs: tuple):
        """Keep the graph when `key` is its own; else drop it and make the
        static tensors anew, on the current stream. `refs` are kept alive
        while the graph may replay, so no address it holds is reused."""
        if key == self.key:
            return
        device = pos_ids_epochs.device
        self.key, self.graph, self.warm, self.refs = key, None, False, refs
        self.pos = torch.empty(pos_ids_epochs.shape[1:],
                               dtype=pos_ids_epochs.dtype, device=device)
        self.neg = torch.empty(neg_ids_epochs.shape[1:],
                               dtype=neg_ids_epochs.dtype, device=device)
        self.val_sel, self.val_msg_mask = _val_rows(val, device)
        self.best_auc = torch.zeros((), device=device)
        self.since = torch.zeros((), dtype=torch.long, device=device)

    def step(self, epoch_fn: Callable, pos_ids: torch.Tensor,
             neg_ids: torch.Tensor, generator: torch.Generator | None,
             key: Callable) -> tuple:
        """One epoch on `pos_ids` and `neg_ids`, copied into the static
        buffers: a replay, else (a new key's first epoch) `epoch_fn` op by
        op, else the capture of `epoch_fn` and its first replay. `key()` is
        the call's key, read again after the epoch op by op has made Adam's
        state. Returns `epoch_fn`'s (loss, auc)."""
        self.pos.copy_(pos_ids)
        self.neg.copy_(neg_ids)
        if self.graph is None and not self.warm:
            out = epoch_fn(self.pos, self.neg, True)
            self.key, self.warm = key(), True
            EPOCH_COUNTS["eager"] += 1
            return out
        if self.graph is None:
            with span("twowl.capture"):
                graph = torch.cuda.CUDAGraph()
                if generator is not None:
                    graph.register_generator_state(generator)
                with torch.cuda.graph(graph, stream=self.stream):
                    self.out = epoch_fn(self.pos, self.neg, True)
            self.graph = graph
            EPOCH_COUNTS["captures"] += 1
        with span("twowl.replay"):
            self.graph.replay()
        EPOCH_COUNTS["replayed"] += 1
        return self.out


# optimizer -> its `_EpochGraph`; an entry goes with its optimizer
_GRAPHS: "weakref.WeakKeyDictionary[torch.optim.Optimizer, _EpochGraph]" = \
    weakref.WeakKeyDictionary()


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


# ---------------------------------------------------------------------------
# trial-major multi-trial training (the hyperparameter sweep)
# ---------------------------------------------------------------------------
#
# The reference keeps the trial axis in trailing dims ([rows, T, C]; the
# embedding table [D+1, T, C]) because gathers with a leading vmap batch
# serialize on the TPU. The port keeps the layout for another reason: every
# gather stays a leading-axis gather of contiguous T*C-wide rows, which is
# what K1 and K3 take, so one launch serves all T trials and the host
# issues the same ~1,000 launches per epoch as for one trial.

TRIAL_EMB_PATH = "emb"


def init_params_trials(cfg: TwoWLConfig, n_trials: int,
                       generator: torch.Generator, device) -> dict:
    """T independent inits, drawn one after another from the CPU
    `generator`, stacked: every leaf gets a leading trial axis, except the
    degree-embedding table, which keeps its index axis leading
    (`[max_degree+1, T, C]`) so a lookup is one leading-axis gather. Leaf
    tensors on `device` that require grad."""
    draws = [_draw_params(cfg, generator) for _ in range(n_trials)]
    params = tree_map(lambda *leaves: torch.stack(leaves), *draws)
    params[TRIAL_EMB_PATH] = params[TRIAL_EMB_PATH].movedim(0, 1).contiguous()
    return tree_map(lambda t: t.to(device).requires_grad_(), params)


def _trial_axes(tree: dict) -> dict:
    """Tree of ints: the trial axis of each leaf of a trial-major tree."""
    axes = tree_map(lambda _: 0, tree)
    axes[TRIAL_EMB_PATH] = 1
    return axes


def _bcast_trial(v: torch.Tensor, leaf_ndim: int, axis: int) -> torch.Tensor:
    """`v` [T] as a view that broadcasts along a leaf's trial axis."""
    shape = [1] * leaf_ndim
    shape[axis] = v.shape[0]
    return v.view(shape)


def extract_trial(params: dict, i: int) -> dict:
    """Single-trial parameters (the standard layout) of trial `i` of a
    trial-major tree, as detached copies."""
    return tree_map(lambda leaf, ax: leaf.detach().select(ax, i).clone(),
                    params, _trial_axes(params))


def take_trials(tree: dict, idx) -> dict:
    """A trial-major tree (the parameters, or the Adam moments) restricted
    to the trials `idx`, in that order. Successive halving keeps its
    survivors warm with it: weights, best weights and Adam moments. Leaves
    that required grad come back as new leaves that do."""
    idx = torch.as_tensor(idx, dtype=torch.long,
                          device=tree_leaves(tree)[0].device)
    return tree_map(
        lambda leaf, ax: leaf.detach().index_select(ax, idx).requires_grad_(
            leaf.requires_grad),
        tree, _trial_axes(tree))


class TrialRates(NamedTuple):
    """Per-trial dropout rates, each [T]."""

    dp_emb: torch.Tensor
    dp_1wl0: torch.Tensor
    dp_1wl1: torch.Tensor
    dp_2wl: torch.Tensor


def _dropout_trials(generator, x: torch.Tensor,
                    rate_t: torch.Tensor) -> torch.Tensor:
    """Dropout of `x` [R, T, C] at each trial's own rate `rate_t` [T]."""
    keep_p = (1.0 - rate_t)[:, None]
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_p
    return torch.where(keep, x / keep_p, 0.0)


def _gcn_conv_trials(p: dict, x: torch.Tensor, src: torch.Tensor,
                     norm: tuple, num_rows: int, plan: tuple,
                     ell: tuple | None = None) -> torch.Tensor:
    """`gcn_conv` in the trial-major layout: x [R, T, C_in] -> [num_rows, T,
    C_out], leaves of `p` with a leading trial axis. With `ell` the
    aggregation runs on K1 over the flattened `[S, T*C_out]` messages."""
    h = torch.einsum("rtc,tcd->rtd", x, p["w"])
    coeff, self_coeff = norm
    msgs = h[src] * coeff[:, None, None]
    if ell is not None:
        agg = segment_sum_ell(num_rows, msgs, plan[0], *ell)
    else:
        agg = segment_sum_planned(msgs, *plan)
    return agg + self_coeff[:, None, None] * h + p["b"][None]


def forward_trials(params: dict, cfg: TwoWLConfig, node_deg: torch.Tensor,
                   arrays: SplitArrays, msg_mask: torch.Tensor,
                   sel_idx: torch.Tensor,
                   generator: torch.Generator | None = None,
                   rates: TrialRates | None = None) -> torch.Tensor:
    """Trial-major forward: T models in one pass; logits [B // 2, T].

    The arguments of `forward`, with trial-major `params`
    (`init_params_trials`); `generator` turns on dropout at the per-trial
    `rates`. The paired 2-WL branch's composed gather-sum carries both
    directions of all T trials as one `[R, T*2C]` call; the unpaired one
    (`from_split(..., paired=False)`) runs a planned segment sum per
    direction. f32 only, as in the reference."""
    train = generator is not None
    N = node_deg.shape[0]
    kernel = cfg.agg_1wl == "ell"

    x = params["emb"][node_deg]  # [N, T, C]
    x = graph_norm(params["emb_gn"], x, cfg.eps)
    if train:
        x = _dropout_trials(generator, x, rates.dp_emb)

    mask_s = msg_mask[arrays.msg_perm]
    norm1 = gcn_norm_coefficients(arrays.msg_src_s, arrays.msg_dst_s, N,
                                  mask_s, plan=arrays.msg_plan)
    ell = (arrays.msg_slots, arrays.msg_sweight) if kernel else None
    for i, layer in enumerate(params["conv1"]):
        x = _gcn_conv_trials(layer, x, arrays.msg_src_s, norm1, N,
                             arrays.msg_plan, ell)
        x = graph_norm(layer["gn"], x, cfg.eps)
        last = i == cfg.depth1 - 1
        if train:
            x = _dropout_trials(generator, x,
                                rates.dp_1wl1 if last else rates.dp_1wl0)
        if cfg.act1 if last else cfg.act0:
            x = torch.relu(x)

    e = edge_hadamard(arrays.pos1_src, arrays.pos1_dst, x)  # [R, T, C]

    if arrays.e1_cops:
        C2 = cfg.channels_2wl
        dinv1, dinv2, mA, mB = _paired_norm(arrays, msg_mask, kernel)
        mA, mB = mA[:, None, None], mB[:, None, None]
        outA, outB = dinv1[:, None, None], dinv2[:, None, None]
        selfA = (dinv1 * dinv1)[:, None, None]
        selfB = (dinv2 * dinv2)[:, None, None]
        for i in range(cfg.depth2):
            lA, lB = params["conv2"][i], params["conv2r"][i]
            hA = torch.einsum("rtc,tcd->rtd", e, lA["w"])
            hB = torch.einsum("rtc,tcd->rtd", e, lB["w"])
            h2 = torch.cat([hA * mA, _swap(hB * mB)], dim=-1)
            out = arrays.paired_sum(h2, *arrays.e1_cops, kernel)
            hA = out[..., :C2] * outA + selfA * hA + lA["b"][None]
            hB = _swap(out[..., C2:]) * outB + selfB * hB + lB["b"][None]
            hA = graph_norm(lA["gn"], hA, cfg.eps)
            hB = graph_norm(lB["gn"], hB, cfg.eps)
            if train:
                hA = _dropout_trials(generator, hA, rates.dp_2wl)
                hB = _dropout_trials(generator, hB, rates.dp_2wl)
            e = torch.relu(hA) + torch.relu(hB)
    else:
        branches = _unpaired_norms(arrays, msg_mask)
        for i in range(cfg.depth2):
            parts = []
            for layer, (src, norm, plan) in zip(
                    (params["conv2"][i], params["conv2r"][i]), branches):
                h = _gcn_conv_trials(layer, e, src, norm, arrays.num_rows,
                                     plan)
                h = graph_norm(layer["gn"], h, cfg.eps)
                if train:
                    h = _dropout_trials(generator, h, rates.dp_2wl)
                parts.append(torch.relu(h))
            e = parts[0] + parts[1]

    sel = e[sel_idx]  # [B, T, C]
    paired = sel[0::2] * sel[1::2]
    logits = torch.einsum("btc,tco->bto", paired, params["pred_w"])[..., 0]
    return logits + params["pred_b"][None, :, 0]


# optax `adam`'s defaults, which the reference's sweep runs at lr 1.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrialAdamState:
    """State of the per-trial Adam: the moments `mu` and `nu`, trees laid
    out as the trial-major parameters (so `take_trials` slices them), and
    the step count, which all trials share."""

    mu: dict
    nu: dict
    count: int = 0


def adam_trials_init(params: dict) -> TrialAdamState:
    return TrialAdamState(mu=tree_map(torch.zeros_like, params),
                          nu=tree_map(torch.zeros_like, params))


@torch.no_grad()
def adam_trials_update(params: dict, grads, state: TrialAdamState,
                       lrs: torch.Tensor) -> None:
    """One per-trial Adam step, in place: the reference's optax `adam(1.0)`
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias correction by
    the shared count), its update scaled by `lrs` [T] along each leaf's
    trial axis. Adam's step does not depend on the gradient's scale, so
    this is Adam at lr_t for every trial. `grads` lists the gradients in
    `tree_leaves(params)` order."""
    leaves = tree_leaves(params)
    mu, nu, grads = tree_leaves(state.mu), tree_leaves(state.nu), list(grads)
    state.count += 1
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
    denom = torch._foreach_div(nu, 1.0 - ADAM_B2 ** state.count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    step = torch._foreach_div(mu, 1.0 - ADAM_B1 ** state.count)
    torch._foreach_div_(step, denom)
    torch._foreach_mul_(step, [
        _bcast_trial(lrs, leaf.dim(), ax)
        for leaf, ax in zip(leaves, tree_leaves(_trial_axes(params)))])
    torch._foreach_sub_(leaves, step)


def train_step_trials(params: dict, opt_state: TrialAdamState,
                      generator: torch.Generator | None,
                      pos_ids: torch.Tensor, neg_ids: torch.Tensor,
                      arrays: SplitArrays, cfg: TwoWLConfig,
                      lrs: torch.Tensor, num_nodes: int,
                      rates: TrialRates) -> torch.Tensor:
    """One step of T trials at once: the batch is shared, the parameters,
    dropout rates and lr are each trial's own. The loss is the sum of the
    per-trial BCE losses, so each trial's gradient is its own. Updates
    `params` and `opt_state` in place; returns the per-trial losses [T],
    detached."""
    with span("twowl.inputs"):
        msg_mask, deg, sel, y = _step_inputs(pos_ids, neg_ids, arrays, cfg,
                                             num_nodes)
    with span("twowl.forward"):
        logits = forward_trials(params, cfg, deg, arrays, msg_mask, sel,
                                generator, rates)
        per_trial = F.binary_cross_entropy_with_logits(
            logits, y[:, None].expand_as(logits), reduction="none").mean(dim=0)
    with span("twowl.backward"):
        grads = torch.autograd.grad(per_trial.sum(), tree_leaves(params))
    with span("twowl.optimizer"):
        adam_trials_update(params, grads, opt_state, lrs)
    return per_trial.detach()


def train_loop_trials(params: dict, opt_state: TrialAdamState,
                      generator: torch.Generator | None,
                      pos_ids_epochs: torch.Tensor,
                      neg_ids_epochs: torch.Tensor, trn: SplitArrays,
                      val: SplitArrays, val_y: torch.Tensor,
                      node_deg: torch.Tensor, cfg: TwoWLConfig,
                      lrs: torch.Tensor, num_nodes: int, rates: TrialRates,
                      init_best: tuple | None = None):
    """The reference's `train_scan_trials` as an epoch loop on the device:
    per epoch one trial-major step, every trial's val AUC
    (`roc_auc_trials`) and a per-trial select of the best-val parameters.
    No early stop and no host read. The spans are `train_loop`'s.

    `init_best` = (best_params, best_aucs [T]) carries the best of earlier
    epochs (successive halving's rungs) and is updated in place. `params`
    and `opt_state` are updated in place. Returns (best_params, best_aucs
    [T], (losses [E, T], aucs [E, T]))."""
    device = val_y.device
    E = pos_ids_epochs.shape[0]
    num_msg_v = val.num_msg
    val_sel = num_msg_v + torch.arange(val.num_rows - num_msg_v,
                                       device=device)
    val_msg_mask = torch.ones(num_msg_v, dtype=torch.bool, device=device)
    if init_best is None:
        init_best = (tree_map(lambda p: p.detach().clone(), params),
                     torch.full((lrs.shape[0],), -1.0, device=device))
    best_params, best_auc = init_best
    best_leaves, leaves = tree_leaves(best_params), tree_leaves(params)
    axes = tree_leaves(_trial_axes(params))
    losses = torch.zeros((E, lrs.shape[0]), device=device)
    aucs = torch.zeros((E, lrs.shape[0]), device=device)
    for epoch in range(E):
        with span("twowl.epoch"):
            mark_step(device)
            losses[epoch] = train_step_trials(
                params, opt_state, generator, pos_ids_epochs[epoch],
                neg_ids_epochs[epoch], trn, cfg, lrs, num_nodes, rates)
            with torch.no_grad(), span("twowl.eval"):
                logits = forward_trials(params, cfg, node_deg, val,
                                        val_msg_mask, val_sel)
                auc = roc_auc_trials(val_y, logits)
                improved = auc > best_auc
                for b, p, ax in zip(best_leaves, leaves, axes):
                    b.copy_(torch.where(_bcast_trial(improved, p.dim(), ax),
                                        p, b))
                best_auc.copy_(torch.where(improved, auc, best_auc))
                aucs[epoch] = auc
    mark_step(device, end=True)
    return best_params, best_auc, (losses, aucs)
