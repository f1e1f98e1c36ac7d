"""SEAL's DGCNN in PyTorch, the counterpart of `linkpred_tpu/models/seal.py`.

The whole dataset is a capacity-padded stack of subgraphs
(`data.subgraph`), and training runs minibatches gathered from it on the
device:

- 4 graph-conv layers `Z = tanh(D^-1 A~ Z W)`, channels 32/32/32/1: D is
  diagonal, so `D^-1` is a row scale, and `A~ @ (Z W)` is a batched `bmm`.
- SortPooling: nodes ordered by the 1-channel Z4 score, cut or zero-padded
  to `threshold_k` rows. Padded nodes score -inf and are zeroed after the
  gather. Ties keep the lower node first (a stable descending sort), as
  `lax.top_k` does.
- conv1d #1 (width = stride = 96) is a per-node matmul of the sorted [k, 96]
  rows; conv1d #2 (width 5, 16 -> 32) is `F.conv1d` on the NCW layout with
  the reference's WIO kernel as `[O, I, W]`. Dense 128 + dropout 0.5 + a
  2-way softmax head.

No hand-written kernel runs here: dense `bmm`, a sort, `conv1d` and small
GEMMs. Deviations of the reference kept as they are: weights initialised
once; dropout applied in training; the last dense layer drawn at std 0.1.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

GRAPH_CONV_CHANNELS = (32, 32, 32, 1)
CONV1D_1_OUT = 16
CONV1D_2_OUT = 32
CONV1D_2_WIDTH = 5
DENSE_NODES = 128
DROPOUT_RATE = 0.5


class DGCNNParams(NamedTuple):
    gw: tuple  # 4 graph-conv weights
    wc1: torch.Tensor  # [96, 16] sort-pooled per-node projection
    wc2: torch.Tensor  # [5, 16, 32] conv1d kernel (WIO)
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def leaves(params: DGCNNParams) -> list:
    """The ten parameter tensors in the order the JAX package flattens
    them (and its checkpoints number them)."""
    return [*params.gw, *params[1:]]


def _rebuild(params: DGCNNParams, fn) -> DGCNNParams:
    return DGCNNParams(tuple(fn(t) for t in params.gw),
                       *(fn(t) for t in params[1:]))


@dataclasses.dataclass(frozen=True)
class DGCNNConfig:
    feature_dim: int
    threshold_k: int
    learning_rate: float = 1e-4
    batch_size: int = 32
    epochs: int = 50
    dropout: float = DROPOUT_RATE
    seed: int = 0


def assemble_inputs(adj_u8: torch.Tensor, tags: torch.Tensor,
                    nodes: torch.Tensor, node_mask: torch.Tensor,
                    emb_table: torch.Tensor | None, tags_size: int):
    """The dense DGCNN inputs built on the device from compact ones:
    (d_inv [.., K], a_tilde = A + I [.., K, K], x = one-hot tag ++ embedding
    rows [.., K, F]), all f32, from a uint8 adjacency, int tags and node
    ids, the node mask and the [N, D] embedding table (or None)."""
    K = adj_u8.shape[-1]
    a_tilde = adj_u8.float() + torch.eye(K, device=adj_u8.device)
    d_inv = 1.0 / a_tilde.sum(dim=-1)
    m = node_mask[..., None].float()
    x = F.one_hot(tags.long(), tags_size).float() * m
    if emb_table is not None:
        x = torch.cat([x, emb_table[nodes.long()] * m], dim=-1)
    return d_inv, a_tilde, x


def _trunc_normal(generator: torch.Generator, shape, stddev=0.1):
    """Normal at `stddev`, cut at two standard deviations."""
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, std=stddev, a=-2 * stddev, b=2 * stddev,
                                generator=generator)
    return t


def _on_device(params: DGCNNParams, device) -> DGCNNParams:
    return _rebuild(params, lambda t: torch.as_tensor(
        t, dtype=torch.float32).to(device).requires_grad_())


def init_params(generator: torch.Generator, feature_dim: int,
                threshold_k: int, device) -> DGCNNParams:
    """The reference's layout and init, drawn on the host from a CPU
    `generator` (a seed gives the same init on every device), as leaf
    tensors on `device` that require grad."""
    chans = (feature_dim,) + GRAPH_CONV_CHANNELS
    gw = tuple(_trunc_normal(generator, (chans[i], chans[i + 1]))
               for i in range(4))
    total_gc = sum(GRAPH_CONV_CHANNELS[:3])  # 96
    dense_in = (threshold_k - CONV1D_2_WIDTH + 1) * CONV1D_2_OUT
    params = DGCNNParams(
        gw=gw,
        wc1=_trunc_normal(generator, (total_gc, CONV1D_1_OUT)),
        wc2=_trunc_normal(generator,
                          (CONV1D_2_WIDTH, CONV1D_1_OUT, CONV1D_2_OUT)),
        w1=_trunc_normal(generator, (dense_in, DENSE_NODES)),
        b1=torch.zeros(DENSE_NODES),
        w2=_trunc_normal(generator, (DENSE_NODES, 2)),
        b2=torch.zeros(2),
    )
    return _on_device(params, device)


def params_from_jax(params, device) -> DGCNNParams:
    """The JAX package's `DGCNNParams` (leaves as numpy arrays, e.g.
    `jax.tree_util.tree_map(np.asarray, params)`) as this module's, leaf for
    leaf, on `device`."""
    def copy(a):
        return np.array(a, dtype=np.float32)

    return _on_device(DGCNNParams(tuple(copy(w) for w in params.gw),
                                  *(copy(t) for t in params[1:])), device)


def adam(params: DGCNNParams, learning_rate: float) -> torch.optim.Adam:
    """Adam over the ten leaves; betas 0.9/0.999, eps 1e-8 and no weight
    decay are optax's `adam(learning_rate)`."""
    return torch.optim.Adam(leaves(params), lr=learning_rate, eps=1e-8)


def graph_conv_layers(params: DGCNNParams, d_inv: torch.Tensor,
                      a_tilde: torch.Tensor, x: torch.Tensor):
    """The 4-layer GCN stack: (concat(Z1..Z3) [B, K, 96], Z4 [B, K, 1])."""
    zs = []
    z = x
    for w in params.gw:
        z = torch.tanh(d_inv[:, :, None] * torch.bmm(a_tilde, z @ w))
        zs.append(z)
    return torch.cat(zs[:3], dim=-1), zs[3]


def sort_pool(cat: torch.Tensor, z4: torch.Tensor, node_mask: torch.Tensor,
              threshold_k: int) -> torch.Tensor:
    """SortPooling: the rows of `cat` ordered by Z4 score, descending, the
    first `threshold_k` kept, padded rows zeroed -> [B, threshold_k, 96].
    Equal scores keep the lower node first."""
    if threshold_k > node_mask.shape[1]:
        raise ValueError(f"threshold_k {threshold_k} > subgraph capacity "
                         f"{node_mask.shape[1]}")
    scores = torch.where(node_mask, z4[:, :, 0], float("-inf"))
    idx = torch.sort(scores, dim=1, descending=True,
                     stable=True).indices[:, :threshold_k]
    pooled = torch.gather(cat, 1, idx[:, :, None].expand(-1, -1,
                                                         cat.shape[2]))
    valid = torch.gather(node_mask, 1, idx)
    return pooled * valid[:, :, None]


def forward(params: DGCNNParams, d_inv: torch.Tensor, a_tilde: torch.Tensor,
            x: torch.Tensor, node_mask: torch.Tensor, threshold_k: int,
            generator: torch.Generator | None = None,
            dropout_rate: float = DROPOUT_RATE,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """Batched DGCNN forward -> logits [B, 2]. Dropout draws from
    `generator` (a generator of the tensors' device), or takes its mask
    `keep` [B, 128] bool as given (the data-parallel step gives each rank
    its rows of the whole batch's mask); neither: no dropout."""
    cat, z4 = graph_conv_layers(params, d_inv, a_tilde, x)
    pooled = sort_pool(cat, z4, node_mask, threshold_k)  # [B, k, 96]
    c1 = pooled @ params.wc1  # conv1d(width = stride = 96): [B, k, 16]
    # the WIO kernel as conv1d's [O, I, W]; NWC <-> NCW around it
    c2 = F.conv1d(c1.transpose(1, 2), params.wc2.permute(2, 1, 0))
    h = c2.transpose(1, 2).reshape(c2.shape[0], -1)  # [B, (k-4) * 32]
    h = torch.relu(h @ params.w1 + params.b1)
    if keep is None and generator is not None and dropout_rate > 0:
        keep = torch.rand(h.shape, generator=generator,
                          device=h.device) < 1.0 - dropout_rate
    if keep is not None and dropout_rate > 0:
        h = torch.where(keep, h / (1.0 - dropout_rate), 0.0)
    return h @ params.w2 + params.b2


def loss_fn(params: DGCNNParams, d_inv, a_tilde, x, node_mask, y,
            threshold_k: int, generator=None,
            dropout_rate: float = DROPOUT_RATE,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch (integer labels)."""
    logits = forward(params, d_inv, a_tilde, x, node_mask, threshold_k,
                     generator, dropout_rate, keep)
    return F.cross_entropy(logits, y.long())


# ---------------------------------------------------------------------------
# training over a stack of subgraphs on the device
# ---------------------------------------------------------------------------


class CompactStack(NamedTuple):
    """The compact dataset on the device: uint8 adjacency [P, K, K], int32
    tags and node ids [P, K], the node mask, the embedding table [N, D] (or
    None) and int64 labels [P]. A minibatch is gathered and assembled into
    dense f32 inputs on the device (`assemble_inputs`)."""
    adj: torch.Tensor
    tags: torch.Tensor
    nodes: torch.Tensor
    node_mask: torch.Tensor
    emb: torch.Tensor | None
    y: torch.Tensor
    tags_size: int

    @staticmethod
    def from_batch(batch, emb, labels, device) -> "CompactStack":
        """Upload a `data.subgraph.SubgraphBatch`, an embedding table
        (array, tensor or None) and labels [P] to `device`."""
        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return CompactStack(
            put(batch.adj), put(batch.tags), put(batch.nodes),
            put(batch.node_mask),
            None if emb is None else torch.as_tensor(
                emb, dtype=torch.float32, device=device),
            put(labels).long(), int(batch.tags_size))

    def minibatch(self, idx: torch.Tensor) -> tuple:
        mask = self.node_mask[idx]
        d_inv, a_tilde, x = assemble_inputs(self.adj[idx], self.tags[idx],
                                            self.nodes[idx], mask, self.emb,
                                            self.tags_size)
        return d_inv, a_tilde, x, mask, self.y[idx]


class DenseStack(NamedTuple):
    """The dataset as dense f32 inputs on the device (`gnn_inputs`'s)."""
    d_inv: torch.Tensor
    a_tilde: torch.Tensor
    x: torch.Tensor
    node_mask: torch.Tensor
    y: torch.Tensor

    def minibatch(self, idx: torch.Tensor) -> tuple:
        return tuple(t[idx] for t in self)


def batch_schedule(rng: np.random.Generator, ids: np.ndarray,
                   batch_size: int, epochs: int) -> np.ndarray:
    """Minibatch ids `[epochs * steps_per_epoch, bs]` int32: per epoch a
    permutation of `ids` cut to whole batches, drawn from `rng` as the JAX
    package draws them."""
    n = len(ids)
    bs = min(batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    return np.concatenate([
        ids[rng.permutation(n)[: steps_per_epoch * bs]].reshape(
            steps_per_epoch, bs)
        for _ in range(epochs)]).astype(np.int32)


def train_steps(params: DGCNNParams, optimizer: torch.optim.Optimizer,
                batch_idx: torch.Tensor, stack, threshold_k: int,
                dropout_rate: float,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """One Adam step per row of `batch_idx` [S, B] (a tensor on the
    stack's device), each on the minibatch `stack.minibatch(row)` of a
    `CompactStack` or `DenseStack`. Returns the losses [S] on the device;
    no step reads anything back to the host."""
    losses = torch.empty(batch_idx.shape[0], device=batch_idx.device)
    for s in range(batch_idx.shape[0]):
        d_inv, a_tilde, x, mask, y = stack.minibatch(batch_idx[s])
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, d_inv, a_tilde, x, mask, y, threshold_k,
                       generator, dropout_rate)
        loss.backward()
        optimizer.step()
        losses[s] = loss.detach()
    return losses


def warm_up(params: DGCNNParams, learning_rate: float,
            batch_idx: torch.Tensor, stack, threshold_k: int,
            dropout_rate: float) -> None:
    """Steps on a throwaway copy of `params` with a throwaway optimizer and
    generator, then a device sync: the library set-up and the allocator's
    first growth stay out of a timed run, which then trains as it would
    have without this call."""
    copy = _rebuild(params, lambda t: t.detach().clone().requires_grad_())
    gen = torch.Generator(device=batch_idx.device).manual_seed(0)
    train_steps(copy, adam(copy, learning_rate), batch_idx, stack,
                threshold_k, dropout_rate, gen)
    if batch_idx.device.type == "cuda":
        torch.cuda.synchronize(batch_idx.device)


@torch.no_grad()
def predict_scores(params: DGCNNParams, d_inv, a_tilde, x, node_mask,
                   threshold_k: int) -> torch.Tensor:
    """Positive-class softmax scores [B]."""
    logits = forward(params, d_inv, a_tilde, x, node_mask, threshold_k)
    return torch.softmax(logits, dim=-1)[:, 1]


@torch.no_grad()
def predict_scores_compact(params: DGCNNParams, adj_u8, tags, nodes,
                           node_mask, emb_table, tags_size: int,
                           threshold_k: int) -> torch.Tensor:
    """`predict_scores` on compact inputs, assembled on the device."""
    d_inv, a_tilde, x = assemble_inputs(adj_u8, tags, nodes, node_mask,
                                        emb_table, tags_size)
    return predict_scores(params, d_inv, a_tilde, x, node_mask, threshold_k)


def threshold_from_sizes(sizes: np.ndarray, top_k_percent: float) -> int:
    """`threshold_k` = the `top_k_percent`-th percentile of subgraph
    sizes, floored at the conv2 width."""
    k = int(np.percentile(np.asarray(sizes), top_k_percent))
    return max(k, CONV1D_2_WIDTH)


def seeds(seed: int) -> tuple[int, int]:
    """(init seed, dropout seed) derived from a run's seed."""
    state = np.random.SeedSequence(seed).generate_state(2)
    return int(state[0]), int(state[1])


def train_dgcnn(cfg: DGCNNConfig, d_inv: np.ndarray, a_tilde: np.ndarray,
                x: np.ndarray, node_mask: np.ndarray, y: np.ndarray,
                eval_every: int = 0, eval_fn=None, verbose: bool = False,
                fused: bool = True, *, device) -> DGCNNParams:
    """Minibatched Adam training over a dense padded stack on `device`.

    The schedule is drawn from `np.random.default_rng(cfg.seed)` as the JAX
    package draws it. `fused=True` (forced when no `eval_fn` is given) runs
    every step in one `train_steps` call and reads the losses once; else the
    steps run an epoch per call and `eval_fn(epoch, params)` is called every
    `eval_every` epochs."""
    device = torch.device(device)
    n = y.shape[0]
    bs = min(cfg.batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    init_seed, drop_seed = seeds(cfg.seed)
    params = init_params(torch.Generator().manual_seed(init_seed),
                         cfg.feature_dim, cfg.threshold_k, device)
    optimizer = adam(params, cfg.learning_rate)
    generator = torch.Generator(device=device).manual_seed(drop_seed)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    stack = DenseStack(put(d_inv), put(a_tilde), put(x), put(node_mask),
                       put(y).long())
    batch_idx = put(batch_schedule(np.random.default_rng(cfg.seed),
                                   np.arange(n), cfg.batch_size, cfg.epochs))
    fused = fused or eval_fn is None
    epoch_chunks = ([batch_idx] if fused
                    else batch_idx.split(steps_per_epoch))
    losses = []
    for k, chunk in enumerate(epoch_chunks):
        losses.append(train_steps(params, optimizer, chunk, stack,
                                  cfg.threshold_k, cfg.dropout, generator))
        if not fused:
            if verbose:
                print(f"epoch {k}: loss {float(losses[-1].mean()):.4f}")
            if eval_every and (k + 1) % eval_every == 0:
                eval_fn(k, params)
    if fused and verbose:
        per_epoch = losses[0].reshape(cfg.epochs, steps_per_epoch).mean(1)
        for epoch in (0, cfg.epochs // 2, cfg.epochs - 1):
            print(f"epoch {epoch}: loss {float(per_epoch[epoch]):.4f}")
    return params
