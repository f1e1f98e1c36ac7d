"""Skip-gram negative-sampling (word2vec) trainer on the device — the
counterpart of `linkpred_tpu/models/word2vec.py`.

One loop over SGD steps. Each step samples a batch of (center, context)
pairs directly from the walk matrix on the device, center-major: a sampled
center position emits `ctx_per_center` context candidates that share one
center gather and one center update, with gensim's reduced window as a
per-center cap on the offset. Negatives come from the unigram^0.75 noise
distribution through an alias table built once per corpus, as one pool of
`neg_pool` rows that every pair of the step scores against with weight
`negatives / neg_pool` (`neg_pool=0`: classic per-pair negatives). Updates
are plain SGD with linear learning-rate decay; rows that collide within a
batch get the sum of their updates (`ops.rows.add_rows_`, as the JAX
package's `.at[].add`), so there is no hogwild, and that sum is taken in a
fixed order, so one seed gives one table on the card too.

The step bodies (`sgns_step_pooled`, `sgns_step_classic`) are functions of
the drawn indices, apart from the draws (`sample_pairs`, `draw_noise`), so
they can be held against the gradient of the SGNS loss. The pooled step is
two calls, `pooled_scores` and `pooled_update`, so that the distributed
trainer (`parallel/sgns.py`) sums the scores over feature slices between
them. The three products with the pool are matrix products
(`torch.matmul`). The host-side table constructors
(`_noise_alias`, `_keep_prob`, `prepare_sgns`) are array-equal to the JAX
package's; the random streams are torch's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from linkpred_tpu_torch.ops.rows import add_rows_
from linkpred_tpu_torch.ops.walk import alias_setup_rows


@dataclasses.dataclass(frozen=True)
class SGNSConfig:
    dim: int = 100
    window: int = 10
    negatives: int = 5
    epochs: int = 5
    batch_size: int = 8192
    lr: float = 0.025
    min_lr: float = 1e-4
    ns_exponent: float = 0.75
    # context candidates emitted per sampled center position; 1 = one pair
    # per center draw
    ctx_per_center: int = 8
    # shared negative pool size per step; 0 = classic per-pair negatives
    neg_pool: int = 512
    # frequent-word subsampling threshold (gensim `sample`); 0 = off. On
    # walk corpora over small graphs the per-node frequency is ~1/N, so
    # gensim's 1e-3 would only starve the hubs
    subsample: float = 0.0


def _noise_alias(counts: np.ndarray, ns_exponent: float):
    """Alias table over the unigram^`ns_exponent` noise distribution, by the
    C++ routine when the host library is at hand (the Python Vose loop costs
    seconds at a 235k-entry vocabulary), else `alias_setup_rows`."""
    from linkpred_tpu_torch import native

    p = counts.astype(np.float64) ** ns_exponent
    p = p / p.sum()
    valid = np.ones((1, len(p)), dtype=bool)
    if native.available():
        J, q = native.build_alias_rows(p[None, :], valid)
    else:
        J, q = alias_setup_rows(p[None, :], valid)
    return J[0], q[0]


def _keep_prob(counts: np.ndarray, sample: float) -> np.ndarray:
    """gensim's subsampling keep-probability per word: keep = (sqrt(f/t) +
    1) * t/f, clipped to 1, with f the corpus frequency and t `sample`."""
    total = counts.sum()
    if sample <= 0 or total == 0:
        return np.ones_like(counts, dtype=np.float32)
    f = np.maximum(counts, 1) / total
    keep = (np.sqrt(f / sample) + 1) * (sample / f)
    return np.minimum(keep, 1.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SGNSPrep:
    """Host-side preparation of one walk corpus: the noise alias table and
    the subsampling keep-probabilities. They depend only on the token
    counts, so build once per corpus (`prepare_sgns`) and reuse."""

    noise_J: np.ndarray
    noise_q: np.ndarray
    keep: np.ndarray
    prep_seconds: float


def prepare_sgns(walks, num_nodes: int,
                 cfg: SGNSConfig = SGNSConfig()) -> SGNSPrep:
    """`walks` is a numpy array or a tensor on any device: a tensor's
    tokens are counted where it lies and only the counts come to the
    host."""
    t0 = time.perf_counter()
    if isinstance(walks, torch.Tensor):
        counts = torch.bincount(walks.reshape(-1).long(),
                                minlength=num_nodes).cpu().numpy()
    else:
        counts = np.bincount(np.asarray(walks).reshape(-1),
                             minlength=num_nodes)
    noise_J, noise_q = _noise_alias(counts, cfg.ns_exponent)
    keep = _keep_prob(counts, cfg.subsample)
    return SGNSPrep(noise_J, noise_q, keep, time.perf_counter() - t0)


def _grid(cfg: SGNSConfig) -> tuple[int, int]:
    """(centers per step, context candidates per center)."""
    nc = max(1, min(cfg.ctx_per_center, cfg.batch_size))
    return max(1, cfg.batch_size // nc), nc


def sample_pairs(generator: torch.Generator, walks: torch.Tensor,
                 cfg: SGNSConfig, keep: torch.Tensor | None = None):
    """Center-major pair sampling from the walk matrix `walks` [W, L]:
    (center [Bc] int64, context [Bc, nc] int64, valid [Bc, nc] bool).

    One [Bc]-row gather pulls each sampled walk row; center and context
    tokens are taken from it. The window cap is drawn once per center
    (gensim's per-position reduced window); a candidate is valid when its
    offset is within the cap and the walk, and it is no self pair (a
    stalled walker's). With `cfg.subsample` > 0, `keep` [N] drops a center
    once per occurrence and a context per pair."""
    W, L = walks.shape
    Bc, nc = _grid(cfg)
    dev = walks.device

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    widx = randint(0, W, (Bc,))
    t = randint(0, L, (Bc,))
    cap = randint(1, cfg.window + 1, (Bc, 1))
    direction = randint(0, 2, (Bc, nc)) * 2 - 1
    mag = randint(1, cfg.window + 1, (Bc, nc))
    ctx_t = t[:, None] + direction * mag
    valid = (mag <= cap) & (ctx_t >= 0) & (ctx_t < L)
    ctx_t = ctx_t.clamp(0, L - 1)
    rows = walks[widx].long()  # [Bc, L]
    center = rows.gather(1, t[:, None])[:, 0]
    context = rows.gather(1, ctx_t)  # [Bc, nc]
    valid &= center[:, None] != context
    if cfg.subsample > 0:
        uc = torch.rand((Bc,), generator=generator, device=dev)
        ux = torch.rand((Bc, nc), generator=generator, device=dev)
        valid &= (uc < keep[center])[:, None] & (ux < keep[context])
    return center, context, valid


def draw_noise(generator: torch.Generator, noise_J: torch.Tensor,
               noise_q: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Noise rows of `shape` (int64) by alias draws from the `[N]` tables."""
    n = noise_q.shape[0]
    un = torch.rand((2, *shape), generator=generator, device=noise_q.device)
    kk = (un[0] * n).long().clamp(max=n - 1)
    return torch.where(un[1] < noise_q[kk], kk, noise_J[kk].long())


@torch.no_grad()
def pooled_scores(w_in: torch.Tensor, w_out: torch.Tensor,
                  center: torch.Tensor, context: torch.Tensor,
                  pool: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pooled step's scores: (pos_score [Bc, nc], neg_score [Bc, P]),
    the dot products of each center row of `w_in` with its context rows
    and with the pool's rows of `w_out`. Over a feature slice of the tables
    they are partial sums, which add up over the slices."""
    Bc, nc = context.shape
    vc = w_in[center]  # [Bc, D]
    uo = w_out[context.reshape(-1)].reshape(Bc, nc, -1)
    return torch.einsum("bd,bnd->bn", vc, uo), vc @ w_out[pool].T


@torch.no_grad()
def pooled_update(w_in: torch.Tensor, w_out: torch.Tensor,
                  center: torch.Tensor, context: torch.Tensor,
                  valid: torch.Tensor, pool: torch.Tensor, lr: float,
                  cfg: SGNSConfig, pos_score: torch.Tensor,
                  neg_score: torch.Tensor) -> None:
    """The pooled step's SGD update, in place on `w_in`, `w_out` [N, D]
    (whole tables or one feature slice of each), given the full scores of
    `pooled_scores` (summed over the slices). Per pair the negative term
    depends only on the center, so a center with v valid pairs takes v
    pooled-negative gradients, each worth `negatives / P` of the pool sum.
    Rows named more than once get the sum of their updates."""
    Bc, nc = context.shape
    vc = w_in[center]  # [Bc, D]
    uo = w_out[context.reshape(-1)].reshape(Bc, nc, -1)
    U = w_out[pool]  # [P, D]

    validf = valid.to(vc.dtype)
    g_pos = (torch.sigmoid(pos_score) - 1.0) * validf  # [Bc, nc]
    nvalid = validf.sum(dim=1) * (cfg.negatives / pool.shape[0])  # [Bc]
    g_neg = torch.sigmoid(neg_score) * nvalid[:, None]  # [Bc, P]

    grad_vc = torch.einsum("bn,bnd->bd", g_pos, uo) + g_neg @ U
    grad_uo = g_pos[:, :, None] * vc[:, None, :]  # [Bc, nc, D]
    grad_pool = g_neg.T @ vc  # [P, D]

    add_rows_(w_in, center, -lr * grad_vc)
    add_rows_(w_out, context.reshape(-1), -lr * grad_uo.reshape(Bc * nc, -1))
    add_rows_(w_out, pool, -lr * grad_pool)


@torch.no_grad()
def sgns_step_pooled(w_in: torch.Tensor, w_out: torch.Tensor,
                     center: torch.Tensor, context: torch.Tensor,
                     valid: torch.Tensor, pool: torch.Tensor, lr: float,
                     cfg: SGNSConfig) -> None:
    """One SGD step with a shared negative pool, in place on `w_in`,
    `w_out` [N, D]: `center` [Bc], `context`/`valid` [Bc, nc], `pool` [P]
    noise rows. `pooled_scores`, then `pooled_update`."""
    pos_score, neg_score = pooled_scores(w_in, w_out, center, context, pool)
    pooled_update(w_in, w_out, center, context, valid, pool, lr, cfg,
                  pos_score, neg_score)


@torch.no_grad()
def sgns_step_classic(w_in: torch.Tensor, w_out: torch.Tensor,
                      center: torch.Tensor, context: torch.Tensor,
                      valid: torch.Tensor, neg: torch.Tensor, lr: float,
                      cfg: SGNSConfig) -> None:
    """One SGD step with per-pair negatives `neg` [Bc, nc, K] (gensim's
    semantics, Bc*nc*K noise rows), in place as `sgns_step_pooled`."""
    Bc, nc, K = neg.shape
    vc = w_in[center]  # [Bc, D]
    uo = w_out[context.reshape(-1)].reshape(Bc, nc, -1)
    un_ = w_out[neg.reshape(-1)].reshape(Bc, nc, K, -1)

    validf = valid.to(vc.dtype)
    pos_score = torch.einsum("bd,bnd->bn", vc, uo)
    neg_score = torch.einsum("bd,bnkd->bnk", vc, un_)
    g_pos = (torch.sigmoid(pos_score) - 1.0) * validf
    g_neg = torch.sigmoid(neg_score) * validf[:, :, None]

    grad_vc = torch.einsum("bn,bnd->bd", g_pos, uo) + torch.einsum(
        "bnk,bnkd->bd", g_neg, un_)
    grad_uo = g_pos[:, :, None] * vc[:, None, :]
    grad_un = g_neg[:, :, :, None] * vc[:, None, None, :]

    add_rows_(w_in, center, -lr * grad_vc)
    add_rows_(w_out, context.reshape(-1), -lr * grad_uo.reshape(Bc * nc, -1))
    add_rows_(w_out, neg.reshape(-1), -lr * grad_un.reshape(Bc * nc * K, -1))


def sgns_schedule(num_tokens: int, num_nodes: int,
                  cfg: SGNSConfig) -> tuple[SGNSConfig, int]:
    """(`cfg` with the batch capped, number of SGD steps) for a corpus of
    `num_tokens` tokens, as the JAX package sizes a run.

    Batch-synchronous SGD sums colliding row updates; on a tiny vocabulary
    a large batch piles O(batch / num_nodes) sequential steps into one jump
    and diverges, so the batch is capped at 16 pair candidates per node.
    gensim trains about `window` pairs per token; of the sampler's
    candidates only 40-55 % are valid, so an epoch proposes `2 * window`
    candidates per token."""
    batch_size = max(64, min(cfg.batch_size, 16 * num_nodes))
    if batch_size != cfg.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    pairs_per_epoch = num_tokens * cfg.window * 2
    Bc, nc = _grid(cfg)
    return cfg, max(int(cfg.epochs * pairs_per_epoch / (Bc * nc)), 1)


@torch.no_grad()
def train_sgns_tables(generator: torch.Generator, walks: torch.Tensor,
                      num_nodes: int, cfg: SGNSConfig = SGNSConfig(),
                      prep: SGNSPrep | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """`train_sgns_device`'s loop, returning both trained tables (input,
    output) [num_nodes, dim] float32 on the device, as the JAX package's
    `_train` does."""
    dev = walks.device
    if prep is None:
        prep = prepare_sgns(walks, num_nodes, cfg)
    noise_J = torch.as_tensor(prep.noise_J, device=dev)
    noise_q = torch.as_tensor(prep.noise_q, device=dev)
    keep = torch.as_tensor(prep.keep, device=dev)

    cfg, num_steps = sgns_schedule(walks.numel(), num_nodes, cfg)
    w_in = (torch.rand((num_nodes, cfg.dim), generator=generator, device=dev)
            - 0.5) / cfg.dim
    w_out = torch.zeros((num_nodes, cfg.dim), device=dev)
    Bc, nc = _grid(cfg)
    for lr in np.linspace(cfg.lr, cfg.min_lr, num_steps).tolist():
        center, context, valid = sample_pairs(generator, walks, cfg, keep)
        if cfg.neg_pool > 0:
            pool = draw_noise(generator, noise_J, noise_q, (cfg.neg_pool,))
            sgns_step_pooled(w_in, w_out, center, context, valid, pool, lr,
                             cfg)
        else:
            neg = draw_noise(generator, noise_J, noise_q,
                             (Bc, nc, cfg.negatives))
            sgns_step_classic(w_in, w_out, center, context, valid, neg, lr,
                              cfg)
    return w_in, w_out


def train_sgns_device(generator: torch.Generator, walks: torch.Tensor,
                      num_nodes: int, cfg: SGNSConfig = SGNSConfig(),
                      prep: SGNSPrep | None = None) -> torch.Tensor:
    """Train SGNS embeddings from the walk matrix `walks` [W, L] (a tensor;
    training runs on its device, with `generator` a `torch.Generator` of
    that device) and return the input table [num_nodes, dim] float32 on
    the device. The loop reads nothing back to the host.

    Nodes that no walk visits keep their (tiny random) init. Pass a
    `prepare_sgns` result as `prep` to skip the noise-table build (it
    depends only on the corpus)."""
    return train_sgns_tables(generator, walks, num_nodes, cfg, prep)[0]


def train_sgns(generator: torch.Generator, walks: torch.Tensor,
               num_nodes: int, cfg: SGNSConfig = SGNSConfig(),
               prep: SGNSPrep | None = None) -> np.ndarray:
    """`train_sgns_device`, with the embeddings copied to a host array
    [num_nodes, dim]."""
    return train_sgns_device(generator, walks, num_nodes, cfg,
                             prep).cpu().numpy()
