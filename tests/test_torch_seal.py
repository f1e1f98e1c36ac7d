"""SEAL in the port (`linkpred_tpu_torch.models.seal`,
`pipelines.seal_pipeline`, `pipelines.seal_scale`, `cli seal`, `cli scale
--family seal`) against the JAX package on the CPU.

Parameters come from the JAX package's `init_params` through
`params_from_jax`. Tolerances: f32 activations, pooled rows and logits agree
to rtol 1e-5, atol 1e-6; the loss and the ten gradients (dropout off) to
rtol 1e-4, atol 1e-6; ten Adam steps from the same parameters on the same
schedule (dropout off) give losses within rtol 1e-4; the committed
checkpoint scores a batch as the JAX package does to atol 1e-5. Host arrays
(pairs, subgraphs, tags, split, schedule, the scale problem) are
array-equal. Mirrors `tests/test_seal.py`.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from linkpred_tpu.data import subgraph as jsg
from linkpred_tpu.models import seal as jseal
from linkpred_tpu.pipelines import seal_pipeline as jsp
from linkpred_tpu.pipelines import seal_scale as jss
from linkpred_tpu.utils import checkpoint as jckpt
from linkpred_tpu_torch import cli
from linkpred_tpu_torch.data import subgraph as sg
from linkpred_tpu_torch.models import seal
from linkpred_tpu_torch.pipelines import seal_pipeline as sp
from linkpred_tpu_torch.pipelines import seal_scale as ss
from linkpred_tpu_torch.utils import checkpoint

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "raw_data", "fb-pages-food")
CKPT = os.path.join(REPO, "checkpoints", "seal", "model-1000.npz")
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def jax_params(seed, feature_dim, threshold_k):
    """(JAX params, the same as the port's)."""
    p = jseal.init_params(jax.random.PRNGKey(seed), feature_dim, threshold_k)
    return p, seal.params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                   "cpu")


@pytest.fixture
def toy_batch(rng):
    B, K, F = 6, 12, 9
    adj = (rng.random((B, K, K)) < 0.2).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.transpose(0, 2, 1)
    sizes = rng.integers(5, K + 1, size=B)
    mask = np.arange(K)[None, :] < sizes[:, None]
    adj *= (mask[:, :, None] & mask[:, None, :])
    a_tilde = adj + np.eye(K, dtype=np.float32)[None]
    d_inv = 1.0 / a_tilde.sum(axis=2)
    x = rng.standard_normal((B, K, F)).astype(np.float32) * mask[:, :, None]
    y = rng.integers(0, 2, size=B).astype(np.int32)
    return (d_inv.astype(np.float32), a_tilde.astype(np.float32), x, mask, y,
            sizes)


def compact_batch(seed, P=40, K=16, N=60, D=7, tags_size=5):
    """A compact stack: uint8 adjacency, tags, node ids, mask, embedding
    table, labels."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((P, K, K)) < 0.25).astype(np.uint8)
    adj = np.triu(adj, 1)
    adj = adj + adj.transpose(0, 2, 1)
    sizes = rng.integers(3, K + 1, size=P).astype(np.int32)
    mask = np.arange(K)[None, :] < sizes[:, None]
    adj *= (mask[:, :, None] & mask[:, None, :]).astype(np.uint8)
    adj[:, 0, 1] = adj[:, 1, 0] = 0
    tags = rng.integers(0, tags_size, (P, K)).astype(np.int32) * mask
    nodes = rng.integers(0, N, (P, K)).astype(np.int32) * mask
    emb = rng.standard_normal((N, D)).astype(np.float32)
    y = rng.integers(0, 2, P).astype(np.int32)
    return adj, tags, nodes, mask, emb, y, tags_size


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_init_layout_and_truncation():
    """The JAX layout, leaf for leaf; draws cut at 2 std (0.2); biases 0;
    the same seed gives the same init."""
    pj, _ = jax_params(0, 21, 30)
    pt = seal.init_params(torch.Generator().manual_seed(3), 21, 30, "cpu")
    lj = jax.tree_util.tree_leaves(pj)
    lt = seal.leaves(pt)
    assert len(lt) == len(lj) == 10
    assert [tuple(t.shape) for t in lt] == [tuple(a.shape) for a in lj]
    assert pt.w1.shape == ((30 - 4) * 32, 128)
    assert all(t.requires_grad and t.dtype == torch.float32 for t in lt)
    draws = torch.cat([t.detach().reshape(-1) for t in lt[:7] + [lt[8]]])
    assert float(draws.abs().max()) <= 0.2
    assert 0.07 < float(draws.std()) < 0.1
    assert not pt.b1.any() and not pt.b2.any()
    again = seal.init_params(torch.Generator().manual_seed(3), 21, 30, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(lt, seal.leaves(again)))


def test_checkpoint_interop_both_ways(tmp_path):
    """A port checkpoint restores in the JAX package and back, the JAX
    tree description included."""
    pj, pt = jax_params(2, 12, 10)
    path = checkpoint.save_pytree(str(tmp_path / "port" / "model"), pt,
                                  step=7)
    back = jckpt.restore_pytree(path, pj)
    for a, b in zip(jax.tree_util.tree_leaves(back), seal.leaves(pt)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    jpath = jckpt.save_pytree(str(tmp_path / "jax" / "model"), pj, step=7)
    with open(path.replace(".npz", ".tree.json")) as f, \
            open(jpath.replace(".npz", ".tree.json")) as g:
        assert json.load(f) == json.load(g)
    restored = checkpoint.restore_pytree(jpath, pt)
    assert isinstance(restored, seal.DGCNNParams)
    for a, b in zip(seal.leaves(restored), jax.tree_util.tree_leaves(pj)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the forward, layer by layer
# ---------------------------------------------------------------------------


class TestGraphConv:
    def test_per_layer_allclose_vs_jax_and_numpy(self, toy_batch):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        pj, pt = jax_params(0, x.shape[2], 8)
        cat, z4 = seal.graph_conv_layers(pt, _t(d_inv), _t(a_tilde), _t(x))
        cj, zj = jseal.graph_conv_layers(pj, jnp.asarray(d_inv),
                                         jnp.asarray(a_tilde), jnp.asarray(x))
        np.testing.assert_allclose(_np(cat), np.asarray(cj), RTOL, ATOL)
        np.testing.assert_allclose(_np(z4), np.asarray(zj), RTOL, ATOL)
        # the independent numpy reference of tests/test_seal.py
        for b in range(x.shape[0]):
            z = x[b]
            for layer, w in enumerate(pj.gw):
                z = np.tanh(np.diag(d_inv[b]) @ a_tilde[b]
                            @ (z @ np.asarray(w)))
                got = (_np(cat)[b, :, 32 * layer: 32 * layer + 32]
                       if layer < 3 else _np(z4)[b])
                np.testing.assert_allclose(got, z, rtol=1e-5, atol=1e-5)

    def test_padded_rows_stay_exactly_zero(self, toy_batch):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        _, pt = jax_params(1, x.shape[2], 8)
        cat, z4 = seal.graph_conv_layers(pt, _t(d_inv), _t(a_tilde), _t(x))
        for b in range(x.shape[0]):
            n = int(sizes[b])
            assert (_np(cat)[b, n:] == 0).all() and (_np(z4)[b, n:] == 0).all()


class TestSortPool:
    def test_orders_by_score_and_zeroes_padding(self):
        cat = np.arange(24, dtype=np.float32).reshape(1, 4, 6)
        z4 = np.array([[[0.1], [0.9], [-0.5], [0.3]]], dtype=np.float32)
        mask = np.array([[True, True, True, False]])
        out = _np(seal.sort_pool(_t(cat), _t(z4), _t(mask), 4))
        np.testing.assert_allclose(out[0, 0], cat[0, 1])
        np.testing.assert_allclose(out[0, 1], cat[0, 0])
        np.testing.assert_allclose(out[0, 2], cat[0, 2])
        np.testing.assert_allclose(out[0, 3], 0.0)

    def test_truncates_to_threshold(self):
        cat = np.ones((1, 10, 6), dtype=np.float32)
        z4 = np.linspace(1, 0, 10, dtype=np.float32).reshape(1, 10, 1)
        out = seal.sort_pool(_t(cat), _t(z4), _t(np.ones((1, 10), bool)), 7)
        assert out.shape == (1, 7, 6)
        with pytest.raises(ValueError, match="threshold_k"):
            seal.sort_pool(_t(cat), _t(z4), _t(np.ones((1, 10), bool)), 11)

    @pytest.mark.parametrize("k", [5, 12])
    def test_ties_between_unequal_rows_like_top_k(self, k):
        """Equal scores (saturated +-1, repeated values, -inf padding) on
        rows that differ: the lower node comes first, as in `lax.top_k`."""
        rng = np.random.default_rng(4)
        B, K = 5, 12
        cat = rng.standard_normal((B, K, 96)).astype(np.float32)
        z4 = rng.choice(np.array([-1.0, 1.0, 0.25, 0.5], np.float32),
                        size=(B, K, 1))
        mask = np.arange(K)[None, :] < np.array([12, 9, 6, 3, 12])[:, None]
        got = _np(seal.sort_pool(_t(cat), _t(z4), _t(mask), k))
        ref = np.asarray(jseal.sort_pool(jnp.asarray(cat), jnp.asarray(z4),
                                         jnp.asarray(mask), k))
        np.testing.assert_array_equal(got, ref)
        # the first tie group of subgraph 0 holds its rows in node order
        top = z4[0, :, 0].max()
        first = np.nonzero(z4[0, :, 0] == top)[0][: min(k, 3)]
        np.testing.assert_array_equal(got[0, : len(first)], cat[0, first])


class TestForwardAndGradients:
    def test_forward_logits_allclose(self, toy_batch):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        pj, pt = jax_params(0, x.shape[2], 8)
        lt = seal.forward(pt, _t(d_inv), _t(a_tilde), _t(x), _t(mask), 8)
        lj = jseal.forward(pj, jnp.asarray(d_inv), jnp.asarray(a_tilde),
                           jnp.asarray(x), jnp.asarray(mask), 8)
        assert lt.shape == (x.shape[0], 2)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), RTOL, ATOL)
        st = seal.predict_scores(pt, _t(d_inv), _t(a_tilde), _t(x),
                                 _t(mask), 8)
        sj = jseal.predict_scores(pj, jnp.asarray(d_inv),
                                  jnp.asarray(a_tilde), jnp.asarray(x),
                                  jnp.asarray(mask), 8)
        np.testing.assert_allclose(_np(st), np.asarray(sj), RTOL, ATOL)
        assert ((_np(st) >= 0) & (_np(st) <= 1)).all()

    @pytest.mark.parametrize("seed", [0, 1])
    def test_loss_and_ten_gradients_allclose(self, seed):
        adj, tags, nodes, mask, emb, y, T = compact_batch(seed, P=24, K=20)
        d, a, x = seal.assemble_inputs(_t(adj), _t(tags), _t(nodes),
                                       _t(mask), _t(emb), T)
        pj, pt = jax_params(seed, x.shape[2], 12)
        loss = seal.loss_fn(pt, d, a, x, _t(mask), _t(y), 12, None, 0.0)
        grads = torch.autograd.grad(loss, seal.leaves(pt), allow_unused=True)
        lj, gj = jax.value_and_grad(jseal.loss_fn)(
            pj, jnp.asarray(_np(d)), jnp.asarray(_np(a)), jnp.asarray(_np(x)),
            jnp.asarray(mask), jnp.asarray(y), 12, None, 0.0)
        np.testing.assert_allclose(float(loss), float(lj), GRAD_RTOL, ATOL)
        gj = jax.tree_util.tree_leaves(gj)
        assert len(gj) == 10
        for i, (g, r) in enumerate(zip(grads, gj)):
            # Z4 only orders the nodes: its weight has no gradient in
            # either package (autograd reports it unused)
            g = np.zeros_like(np.asarray(r)) if g is None else _np(g)
            np.testing.assert_allclose(g, np.asarray(r), GRAD_RTOL, ATOL,
                                       err_msg=f"leaf {i}")
        assert grads[3] is None and not np.asarray(gj[3]).any()

    def test_dropout_scales_kept_units(self, toy_batch):
        """Dropout keeps about half the dense units, scaled by 2; the same
        generator state gives the same logits."""
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        _, pt = jax_params(0, x.shape[2], 8)
        args = (_t(d_inv), _t(a_tilde), _t(x), _t(mask), 8)
        a = seal.forward(pt, *args, torch.Generator().manual_seed(5), 0.5)
        b = seal.forward(pt, *args, torch.Generator().manual_seed(5), 0.5)
        c = seal.forward(pt, *args)
        assert torch.equal(a, b) and not torch.allclose(a, c)


class TestTraining:
    def test_ten_adam_steps_match_jax(self):
        """Ten steps of the compact loop from shared params, on the same
        schedule, dropout off: the JAX `train_scan_compact` and the port's
        `train_steps` give the same losses."""
        adj, tags, nodes, mask, emb, y, T = compact_batch(3)
        F, k, lr = T + emb.shape[1], 10, 3e-3
        pj, pt = jax_params(5, F, k)
        idx = seal.batch_schedule(np.random.default_rng(1), np.arange(40), 8,
                                  2)
        assert idx.shape == (10, 8)
        opt = optax.adam(lr)
        _, _, lj = jseal.train_scan_compact(
            pj, opt.init(pj), jax.random.PRNGKey(0), jnp.asarray(idx),
            jnp.asarray(adj), jnp.asarray(tags), jnp.asarray(nodes),
            jnp.asarray(mask), jnp.asarray(emb), jnp.asarray(y), T, k, 0.0,
            opt, len(idx))
        stack = seal.CompactStack(_t(adj), _t(tags), _t(nodes), _t(mask),
                                  _t(emb), _t(y).long(), T)
        lt = seal.train_steps(pt, seal.adam(pt, lr), _t(idx), stack, k, 0.0)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=1e-4,
                                   atol=0)

    def test_batch_schedule_is_the_jax_draw(self):
        n, bs, epochs = 37, 8, 3
        rng = np.random.default_rng(0)
        expect = np.concatenate([rng.permutation(n)[:32].reshape(4, 8)
                                 for _ in range(epochs)])
        got = seal.batch_schedule(np.random.default_rng(0), np.arange(n), bs,
                                  epochs)
        np.testing.assert_array_equal(got, expect)
        ids = np.arange(100, 137)
        np.testing.assert_array_equal(
            seal.batch_schedule(np.random.default_rng(0), ids, bs, epochs),
            ids[expect])

    @pytest.mark.parametrize("fused", [True, False])
    def test_train_dgcnn_reduces_loss(self, toy_batch, fused):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        cfg = seal.DGCNNConfig(feature_dim=x.shape[2], threshold_k=8,
                               learning_rate=3e-3, batch_size=6, epochs=40,
                               dropout=0.0)
        args = (_t(d_inv), _t(a_tilde), _t(x), _t(mask), _t(y))
        p0 = seal.init_params(
            torch.Generator().manual_seed(seal.seeds(0)[0]), x.shape[2], 8,
            "cpu")
        loss0 = float(seal.loss_fn(p0, *args, 8, None, 0.0))
        calls = []
        params = seal.train_dgcnn(
            cfg, d_inv, a_tilde, x, mask, y, eval_every=10,
            eval_fn=None if fused else (lambda e, p: calls.append(e)),
            fused=fused, device="cpu")
        assert float(seal.loss_fn(params, *args, 8, None, 0.0)) < loss0
        assert calls == ([] if fused else [9, 19, 29, 39])

    def test_fused_and_callback_forms_agree(self, toy_batch):
        d_inv, a_tilde, x, mask, y, sizes = toy_batch
        cfg = seal.DGCNNConfig(feature_dim=x.shape[2], threshold_k=8,
                               learning_rate=1e-3, batch_size=4, epochs=3)
        a = seal.train_dgcnn(cfg, d_inv, a_tilde, x, mask, y, device="cpu")
        b = seal.train_dgcnn(cfg, d_inv, a_tilde, x, mask, y, eval_every=1,
                             eval_fn=lambda e, p: None, fused=False,
                             device="cpu")
        for u, v in zip(seal.leaves(a), seal.leaves(b)):
            torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-7)

    def test_threshold_from_sizes(self):
        sizes = np.array([10, 20, 30, 40, 50, 60, 70, 80, 90, 100])
        assert seal.threshold_from_sizes(sizes, 60.0) == \
            jseal.threshold_from_sizes(sizes, 60.0)
        assert seal.threshold_from_sizes(np.array([2, 3]), 60.0) == \
            seal.CONV1D_2_WIDTH


class TestCompactInputs:
    def test_assemble_matches_host_and_jax(self, rng):
        adj, tags, nodes, mask, emb, y, T = compact_batch(7, P=5, K=12, N=30)
        batch = sg.SubgraphBatch(nodes=nodes, node_mask=mask, adj=adj,
                                 sizes=mask.sum(1).astype(np.int32),
                                 tags=tags, tags_size=T)
        host = sg.gnn_inputs(batch, emb)
        got = seal.assemble_inputs(_t(adj), _t(tags), _t(nodes), _t(mask),
                                   _t(emb), T)
        ref = jseal.assemble_inputs(jnp.asarray(adj), jnp.asarray(tags),
                                    jnp.asarray(nodes), jnp.asarray(mask),
                                    jnp.asarray(emb), T)
        for g, h, r in zip(got, host, ref):
            np.testing.assert_array_equal(_np(g), h)
            np.testing.assert_array_equal(_np(g), np.asarray(r))
        d0 = seal.assemble_inputs(_t(adj), _t(tags), _t(nodes), _t(mask),
                                  None, T)
        np.testing.assert_array_equal(_np(d0[2]),
                                      sg.gnn_inputs(batch, None)[2])

    def test_predict_scores_compact_matches_jax(self):
        adj, tags, nodes, mask, emb, y, T = compact_batch(8)
        pj, pt = jax_params(1, T + emb.shape[1], 9)
        got = seal.predict_scores_compact(pt, _t(adj), _t(tags), _t(nodes),
                                          _t(mask), _t(emb), T, 9)
        ref = jseal.predict_scores_compact(
            pj, jnp.asarray(adj), jnp.asarray(tags), jnp.asarray(nodes),
            jnp.asarray(mask), jnp.asarray(emb), T, 9)
        np.testing.assert_allclose(_np(got), np.asarray(ref), RTOL, ATOL)


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------


def test_restored_checkpoint_scores_like_jax():
    """The committed checkpoint (feature_dim 114, threshold_k 100) restores
    and scores a fixed batch as the JAX package's restore does."""
    pt = sp.restore_seal_params(114, 100, CKPT, device="cpu")
    assert pt.w1.shape == (3072, 128)
    pj = jsp.restore_seal_params(114, 100, CKPT)
    adj, tags, nodes, mask, emb, y, T = compact_batch(9, P=8, K=100, N=200,
                                                      D=100, tags_size=14)
    got = seal.predict_scores_compact(pt, _t(adj), _t(tags), _t(nodes),
                                      _t(mask), _t(emb), T, 100)
    ref = jseal.predict_scores_compact(
        pj, jnp.asarray(adj), jnp.asarray(tags), jnp.asarray(nodes),
        jnp.asarray(mask), jnp.asarray(emb), T, 100)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-5)


def test_restore_defaults_to_latest_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        sp.restore_seal_params(114, 100, device="cpu")
    os.makedirs("checkpoints/seal")
    for step in (3, 1000):
        os.symlink(CKPT, f"checkpoints/seal/model-{step}.npz")
    assert sp.restore_seal_params(114, 100, device="cpu").w1.shape == (
        3072, 128)


def test_restore_without_a_card_raises(tmp_path, monkeypatch):
    """With no card visible and no device named, a restore raises instead
    of restoring to the CPU; a missing checkpoint still raises
    FileNotFoundError first."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FileNotFoundError):
        sp.restore_seal_params(114, 100)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        sp.restore_seal_params(114, 100, CKPT)


def test_config_fields_and_defaults_match():
    assert dataclasses.asdict(sp.SEALConfig()) == \
        dataclasses.asdict(jsp.SEALConfig())
    assert dataclasses.asdict(ss.ScaleSEALConfig()) == \
        dataclasses.asdict(jss.ScaleSEALConfig())


JAX_SEAL_KEYS = {"auc", "accuracy", "hop", "threshold_k", "train_seconds",
                 "compile_seconds", "total_seconds", "params"}


def test_run_seal_host_arrays_equal_jax(tmp_path, monkeypatch):
    """`run_seal` at 2 epochs in both packages at one seed: the pairs, the
    subgraphs and tags, the split and the schedule are array-equal; each
    returns the JAX keys and writes only where it was told to."""
    seen = {}
    build = jsg.build_subgraph_batch
    compact = jseal.train_scan_compact
    predict = jseal.predict_scores_compact

    def build_spy(pairs, adj, hop, *a, **kw):
        seen["pairs"], seen["hop"] = np.asarray(pairs), hop
        seen["batch"] = build(pairs, adj, hop, *a, **kw)
        return seen["batch"]

    class CompactSpy:
        @staticmethod
        def lower(*args, **kw):
            seen["batch_idx"] = np.asarray(args[3])
            seen["labels"] = np.asarray(args[9])
            return compact.lower(*args, **kw)

    def predict_spy(params, adj, tags, nodes, mask, *a):
        seen["test_tags"], seen["test_nodes"] = (np.asarray(tags),
                                                 np.asarray(nodes))
        return predict(params, adj, tags, nodes, mask, *a)

    monkeypatch.setattr(jsg, "build_subgraph_batch", build_spy)
    monkeypatch.setattr(jseal, "train_scan_compact", CompactSpy)
    monkeypatch.setattr(jseal, "predict_scores_compact", predict_spy)
    monkeypatch.chdir(tmp_path)
    cfg_j = jsp.SEALConfig(epochs=2, records_dir=str(tmp_path / "jrec"))
    res_j = jsp.run_seal(cfg_j, data_dir=DATA_DIR, verbose=False)
    assert set(res_j) == JAX_SEAL_KEYS

    prepare = sp.prepare
    monkeypatch.setattr(sp, "prepare", lambda *a, **kw: seen.setdefault(
        "port", prepare(*a, **kw)))
    os.makedirs("port")
    monkeypatch.chdir(tmp_path / "port")
    cfg = sp.SEALConfig(epochs=2, records_dir=str(tmp_path / "rec"))
    res = sp.run_seal(cfg, DATA_DIR, device="cpu", verbose=False,
                      roc_png=None, metrics_file=str(tmp_path / "m.jsonl"),
                      checkpoint_prefix=str(tmp_path / "ck" / "model"))
    data = seen["port"]
    np.testing.assert_array_equal(data.pairs, seen["pairs"])
    assert data.hop == seen["hop"]
    for f in ("nodes", "node_mask", "adj", "sizes", "tags"):
        np.testing.assert_array_equal(getattr(data.batch, f),
                                      getattr(seen["batch"], f), err_msg=f)
    np.testing.assert_array_equal(data.labels, seen["labels"])
    np.testing.assert_array_equal(data.batch_idx, seen["batch_idx"])
    np.testing.assert_array_equal(data.batch.tags[data.te], seen["test_tags"])
    np.testing.assert_array_equal(data.batch.nodes[data.te],
                                  seen["test_nodes"])
    assert len(data.tr) + len(data.te) == len(data.labels)
    assert data.emb.shape == (620, 100) and torch.isfinite(data.emb).all()

    assert set(res) == JAX_SEAL_KEYS and res["compile_seconds"] == 0.0
    assert (res["hop"], res["threshold_k"]) == (res_j["hop"],
                                                res_j["threshold_k"])
    assert 0.5 < res["auc"] <= 1.0 and 0.0 <= res["accuracy"] <= 1.0
    assert os.listdir(tmp_path / "port") == []
    assert (tmp_path / "ck" / "model-1000.npz").exists()
    assert (tmp_path / "rec" / "fb-pages-food_auc_record_seal.txt").exists()
    line = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    assert line["family"] == "seal" and line["compile_seconds"] == 0.0


SMALL_SCALE = dict(nodes=2000, edges=8000, target_pairs=128, epochs=3,
                   max_neighbors=30)


@pytest.mark.parametrize("seed", [0, 3])
def test_build_problem_equal(seed):
    cfg = ss.ScaleSEALConfig(**SMALL_SCALE, seed=seed)
    gt, parts_t = ss.build_problem(cfg)
    gj, parts_j = jss.build_problem(jss.ScaleSEALConfig(**SMALL_SCALE,
                                                        seed=seed))
    for a, b in zip(parts_t, parts_j):
        np.testing.assert_array_equal(a, b)
    for f in ("src", "dst", "indptr", "indices", "nbr", "nbr_mask"):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f),
                                      err_msg=f)


def test_run_seal_scale_small():
    """The pipeline at a small size on the CPU: the JAX keys, the C++ plane's
    extraction, a finite loss and AUC."""
    out = ss.run_seal_scale(ss.ScaleSEALConfig(**SMALL_SCALE), device="cpu",
                            verbose=False)
    jax_keys = {"nodes", "directed_edges", "hop", "target_pairs",
                "subgraphs_per_s", "extract_seconds", "mean_subgraph_size",
                "tags_size", "loss_first_quarter", "loss_last_quarter",
                "loss_decreased", "test_auc", "train_seconds",
                "compile_seconds", "build_seconds", "use_embedding"}
    assert set(out) == jax_keys
    assert out["target_pairs"] == 256 and out["compile_seconds"] == 0.0
    assert np.isfinite(out["loss_last_quarter"]) and 0 <= out["test_auc"] <= 1
    emb = ss.run_seal_scale(
        ss.ScaleSEALConfig(**{**SMALL_SCALE, "epochs": 1},
                           use_embedding=True, emb_dim=8),
        device="cpu", verbose=False)
    assert emb["use_embedding"] and np.isfinite(emb["loss_first_quarter"])


def test_cli_parses_and_runs_seal(tmp_path, monkeypatch, capsys):
    """`seal` and `scale --family seal` parse as the JAX CLI's and run at a
    small size (on the CPU here: the card is replaced)."""
    p = cli.build_parser()
    a = p.parse_args(["--seed", "2", "seal", "--epochs", "5", "--hop", "1"])
    assert (a.cmd, a.seed, a.epochs, a.hop, a.roc_png) == (
        "seal", 2, 5, "1", None)
    a = p.parse_args(["seal"])
    assert (a.epochs, a.hop) == (None, None)
    a = p.parse_args(["scale", "--family", "seal", "--hop", "1"])
    assert (a.family, a.hop) == ("seal", 1)
    assert p.parse_args(["scale", "--family", "seal"]).hop == 2

    from linkpred_tpu_torch.utils import device

    monkeypatch.setattr(device, "cuda_device", lambda: torch.device("cpu"))
    monkeypatch.chdir(tmp_path)
    seen = []
    real = sp.run_seal

    def spy(cfg, **kw):
        seen.append((cfg.seed, cfg.epochs, cfg.hop, cfg.max_neighbors,
                     cfg.dimension, kw["roc_png"]))
        return real(cfg, **kw)

    monkeypatch.setattr(sp, "run_seal", spy)
    cli.main(["--quiet", "--seed", "1", "--set", "seal.max_neighbors=20",
              "--set", "seal.dimension=16", "seal", "--epochs", "1", "--hop",
              "auto"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("AUC:") and "Time:" in line
    assert seen == [(1, 1, "auto", 20, 16, None)]
    assert (tmp_path / "records_auc" /
            "fb-pages-food_auc_record_seal.txt").exists()
    assert (tmp_path / "checkpoints" / "seal" / "model-1000.npz").exists()
    assert (tmp_path / "logs" / "metrics.jsonl").exists()
    assert not (tmp_path / "assets").exists()  # no plot was asked for

    # the scale defaults (4,096 targets, 10 epochs) are a card's work
    scale_cfg = ss.ScaleSEALConfig
    monkeypatch.setattr(ss, "ScaleSEALConfig", lambda **kw: scale_cfg(
        **{**SMALL_SCALE, "epochs": 1, **kw}))
    cli.main(["--quiet", "scale", "--family", "seal", "--nodes", "1500",
              "--edges", "6000", "--hop", "1"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["nodes"] == 1500 and res["hop"] == 1
    assert np.isfinite(res["loss_last_quarter"])


def test_bare_run_seal_writes_no_plot(tmp_path, monkeypatch):
    """`run_seal` draws its ROC plot only where `roc_png` names a file, as
    `run_logistic` and `run_twowl` do: a bare call writes nothing under
    `assets/` (and needs no matplotlib)."""
    monkeypatch.chdir(tmp_path)
    res = sp.run_seal(sp.SEALConfig(epochs=1, hop=1, max_neighbors=20,
                                    dimension=8), device="cpu", verbose=False)
    assert 0.0 <= res["auc"] <= 1.0
    assert not (tmp_path / "assets").exists()
    assert (tmp_path / "records_auc" /
            "fb-pages-food_auc_record_seal.txt").exists()
