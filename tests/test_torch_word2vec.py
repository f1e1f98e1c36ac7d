"""Parity of the port's SGNS trainer (`linkpred_tpu_torch/models/word2vec.py`)
with the JAX package's, on the CPU.

Host-side tables array-equal. The step bodies are held against `w - lr *
jax.grad(loss)` of the SGNS loss written out here, on indices with
deliberate collisions (rtol 1e-5, atol 1e-6: f32 sums in another order).
The trainer draws from torch's random stream, so whole runs are compared by
what they learn, as the JAX package's own tests do.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linkpred_tpu.models import word2vec as jw2v
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.models import word2vec as w2v
from linkpred_tpu_torch.ops.walk import WalkEngine

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def test_config_fields_and_defaults_match():
    ct, cj = w2v.SGNSConfig(), jw2v.SGNSConfig()
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)


def test_noise_alias_and_keep_prob_equal():
    counts = np.random.default_rng(0).integers(0, 500, 300)
    for got, ref in zip(w2v._noise_alias(counts, 0.75),
                        jw2v._noise_alias(counts, 0.75)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    for sample in (0.0, 1e-3):
        got, ref = w2v._keep_prob(counts, sample), jw2v._keep_prob(counts,
                                                                    sample)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_prepare_sgns_equal(as_tensor):
    walks = np.random.default_rng(3).integers(0, 50, (64, 8), np.int32)
    cfg = w2v.SGNSConfig(subsample=1e-3)
    got = w2v.prepare_sgns(torch.as_tensor(walks) if as_tensor else walks,
                           60, cfg)
    ref = jw2v.prepare_sgns(walks, 60, jw2v.SGNSConfig(subsample=1e-3))
    for name in ("noise_J", "noise_q", "keep"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert got.prep_seconds >= 0


def test_schedule_matches_jax_sizing():
    """Batch cap, pair budget and step count, as `train_sgns_device` of the
    JAX package computes them."""
    for tokens, nodes, cfg in (
            (496_000, 620, w2v.SGNSConfig()),
            (64 * 8, 50, w2v.SGNSConfig(epochs=1, batch_size=256)),
            (10_000, 3, w2v.SGNSConfig(batch_size=8192, ctx_per_center=1))):
        got_cfg, steps = w2v.sgns_schedule(tokens, nodes, cfg)
        batch = max(64, min(cfg.batch_size, 16 * nodes))
        nc = max(1, min(cfg.ctx_per_center, batch))
        per_step = max(1, batch // nc) * nc
        assert got_cfg.batch_size == batch
        assert steps == max(int(cfg.epochs * tokens * cfg.window * 2
                                / per_step), 1)


def _colliding_indices(rng, n, bc, nc, extra):
    center = rng.integers(0, n, bc)
    center[1] = center[0]  # two centers name one row
    context = rng.integers(0, n, (bc, nc))
    context[0, 0] = context[0, 1] = center[2]  # a context row that is also
    context[3] = context[2]  # a center; two equal context rows
    valid = rng.random((bc, nc)) < 0.7
    valid[0, :2] = True
    noise = rng.integers(0, n, extra)
    noise.reshape(-1)[:2] = context[0, 0]  # a noise row that is a context
    return center, context, valid, noise


def _step_inputs(seed, n=12, d=5, bc=6, nc=4):
    rng = np.random.default_rng(seed)
    w_in = rng.standard_normal((n, d)).astype(np.float32)
    w_out = rng.standard_normal((n, d)).astype(np.float32)
    return rng, w_in, w_out, n, bc, nc


def test_step_pooled_equals_loss_gradient():
    rng, w_in, w_out, n, bc, nc = _step_inputs(0)
    cfg = w2v.SGNSConfig(negatives=5, neg_pool=7)
    center, context, valid, pool = _colliding_indices(rng, n, bc, nc, (7,))
    lr = 0.05

    def loss(w_in, w_out):
        vc = w_in[center]
        pos = jnp.einsum("bd,bnd->bn", vc, w_out[context])
        neg = vc @ w_out[pool].T  # [bc, P]
        v = jnp.asarray(valid, jnp.float32)
        # a pair's negatives: the pool's sum, each row worth negatives / P
        per_pair_neg = (cfg.negatives / len(pool)) * jnp.sum(
            -jax.nn.log_sigmoid(-neg), axis=1)
        return jnp.sum(v * (-jax.nn.log_sigmoid(pos) + per_pair_neg[:, None]))

    g_in, g_out = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w_in),
                                                 jnp.asarray(w_out))
    t_in, t_out = torch.tensor(w_in), torch.tensor(w_out)
    w2v.sgns_step_pooled(t_in, t_out, torch.as_tensor(center),
                         torch.as_tensor(context), torch.as_tensor(valid),
                         torch.as_tensor(pool), lr, cfg)
    np.testing.assert_allclose(t_in.numpy(), w_in - lr * np.asarray(g_in),
                               **STEP_TOL)
    np.testing.assert_allclose(t_out.numpy(), w_out - lr * np.asarray(g_out),
                               **STEP_TOL)


def test_step_classic_equals_loss_gradient():
    rng, w_in, w_out, n, bc, nc = _step_inputs(1)
    cfg = w2v.SGNSConfig(negatives=3, neg_pool=0)
    center, context, valid, neg = _colliding_indices(rng, n, bc, nc,
                                                     (bc, nc, 3))
    lr = 0.05

    def loss(w_in, w_out):
        vc = w_in[center]
        pos = jnp.einsum("bd,bnd->bn", vc, w_out[context])
        negs = jnp.einsum("bd,bnkd->bnk", vc, w_out[neg])
        v = jnp.asarray(valid, jnp.float32)
        return jnp.sum(v * (-jax.nn.log_sigmoid(pos)
                            + jnp.sum(-jax.nn.log_sigmoid(-negs), axis=2)))

    g_in, g_out = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w_in),
                                                 jnp.asarray(w_out))
    t_in, t_out = torch.tensor(w_in), torch.tensor(w_out)
    w2v.sgns_step_classic(t_in, t_out, torch.as_tensor(center),
                          torch.as_tensor(context), torch.as_tensor(valid),
                          torch.as_tensor(neg), lr, cfg)
    np.testing.assert_allclose(t_in.numpy(), w_in - lr * np.asarray(g_in),
                               **STEP_TOL)
    np.testing.assert_allclose(t_out.numpy(), w_out - lr * np.asarray(g_out),
                               **STEP_TOL)


@pytest.mark.parametrize("subsample", [0.0, 0.5])
def test_sample_pairs_masks(subsample):
    """Window cap, range and self-pair masks: a valid pair lies in the same
    walk within `window` positions of its center and joins two tokens."""
    rng = np.random.default_rng(4)
    W, L, window = 40, 9, 3
    walks = rng.integers(0, 30, (W, L)).astype(np.int32)
    walks[5] = 7  # a stalled walker: only self pairs
    # tag each token with its position so that a pair can be located
    tagged = walks.astype(np.int64) + 1000 * (np.arange(W)[:, None] * L
                                              + np.arange(L)[None, :])
    cfg = w2v.SGNSConfig(window=window, batch_size=4096, ctx_per_center=8,
                         subsample=subsample)
    keep = torch.full((30,), 0.5)
    gen = torch.Generator().manual_seed(0)
    center, context, valid = w2v.sample_pairs(
        gen, torch.as_tensor(tagged), dataclasses.replace(cfg, subsample=0.0))
    assert center.shape == (512,) and context.shape == valid.shape == (512, 8)
    pos_c, pos_x = center // 1000, context // 1000
    same_walk = (pos_c // L)[:, None] == pos_x // L
    offset = (pos_x - pos_c[:, None]).abs()
    assert bool((same_walk & (offset >= 1) & (offset <= window))[valid].all())
    # every in-range offset occurs, and the cap removes wide ones more often
    counts = torch.bincount(offset[valid], minlength=window + 1)[1:]
    assert (counts > 0).all() and counts[0] > counts[-1]
    # on the untagged walks: no valid self pair, and subsampling only drops
    c2, x2, v2 = w2v.sample_pairs(torch.Generator().manual_seed(0),
                                  torch.as_tensor(walks), cfg, keep)
    assert not bool((c2[:, None] == x2)[v2].any())
    if subsample > 0:
        _, _, v_all = w2v.sample_pairs(
            torch.Generator().manual_seed(0), torch.as_tensor(walks),
            dataclasses.replace(cfg, subsample=0.0))
        assert bool((v_all | ~v2).all()) and v2.sum() < 0.6 * v_all.sum()


def _two_cliques():
    pairs = []
    for a in range(8):
        for b in range(a + 1, 8):
            pairs.append((a, b))
            pairs.append((a + 8, b + 8))
    pairs.append((0, 8))  # bridge
    pairs = np.asarray(pairs)
    return Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=16)


@pytest.mark.parametrize("neg_pool", [512, 0], ids=["pooled", "classic"])
def test_two_cliques_separate(neg_pool):
    """Embeddings from walks on two cliques joined by one bridge edge are
    far more similar within a clique than across, on the pooled and on the
    classic negatives path (the JAX package's two tests of the same)."""
    walks = WalkEngine(_two_cliques(), device="cpu").walks(
        torch.Generator().manual_seed(0), 40, 12)
    emb = w2v.train_sgns(
        torch.Generator().manual_seed(1), walks, 16,
        w2v.SGNSConfig(dim=16, window=4, negatives=5, epochs=3,
                       batch_size=2048, neg_pool=neg_pool))
    assert emb.shape == (16, 16) and emb.dtype == np.float32
    e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sim = e @ e.T
    intra = ((sim[:8, :8].sum() - 8) + (sim[8:, 8:].sum() - 8)) / (8 * 7) / 2
    inter = sim[:8, 8:].mean()
    assert intra > inter + 0.2, (intra, inter)


def test_prep_path_matches_inline():
    walks = torch.as_tensor(
        np.random.default_rng(3).integers(0, 50, (64, 8), np.int32))
    cfg = w2v.SGNSConfig(dim=16, epochs=1, batch_size=256)
    a = w2v.train_sgns(torch.Generator().manual_seed(5), walks, 50, cfg)
    prep = w2v.prepare_sgns(walks, 50, cfg)
    b = w2v.train_sgns(torch.Generator().manual_seed(5), walks, 50, cfg,
                       prep=prep)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # unvisited nodes keep their init, bounded by 0.5 / dim
    c = w2v.train_sgns(torch.Generator().manual_seed(5), walks, 60, cfg)
    assert np.abs(c[50:]).max() <= 0.5 / 16
