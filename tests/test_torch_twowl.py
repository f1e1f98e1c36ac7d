"""Parity of the port's TwoWL model and pipeline with the JAX package.

Inputs and the JAX initial parameters are fed to both packages
(`params_from_jax`); dropouts are 0 wherever values are compared. The JAX
side runs the Pallas 1-WL kernel in interpret mode on the toy graph and the
'plan' aggregation at fb-pages-food scale; the port runs 'ell' (kernels K1
and K3, whose plain versions serve CPU tensors). Tolerances: host structures
array-equal; forward values rtol 1e-5, atol 1e-6 (f32 sums in another
order); parameters after Adam steps and loss/AUC histories rtol 1e-4.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from linkpred_tpu.data import io
from linkpred_tpu.data import twowl as dt
from linkpred_tpu.models import twowl as jm
from linkpred_tpu.pipelines import twowl_pipeline as jp
from linkpred_tpu.utils.metrics import roc_auc_score
from linkpred_tpu_torch import cli
from linkpred_tpu_torch.models import twowl as tm
from linkpred_tpu_torch.pipelines import twowl_pipeline as tp

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

NO_DROP = dict(dp_emb=0.0, dp_1wl0=0.0, dp_1wl1=0.0, dp_2wl=0.0)


@pytest.fixture(scope="module")
def toy_data():
    rng = np.random.default_rng(7)
    n = 30
    extra = np.stack([rng.integers(0, n, 80), rng.integers(0, n, 80)], axis=1)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    pairs = np.concatenate([chain, extra], axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return dt.build_twowl_data(pairs, n, rng=rng, ei2_bucket=256)


@pytest.fixture(scope="module")
def fb_data():
    _, edges = io.load_fb_pages_food()
    return dt.build_twowl_data(edges, int(edges.max()) + 1,
                               rng=np.random.default_rng(0))


def _cfgs(d, ell=True, **kw):
    """(JAX config, port config) of one architecture; the 1-WL aggregation
    is JAX 'pallas' (interpret) vs port 'ell', or 'plan' on both."""
    cj = jm.TwoWLConfig(max_degree=d.max_degree, **kw)
    ct = tm.TwoWLConfig(max_degree=d.max_degree, **kw)
    if ell:
        cj = dataclasses.replace(cj, agg_1wl="pallas", pallas_interpret=True)
        ct = dataclasses.replace(ct, agg_1wl="ell")
    return cj, ct


def _jax_init(cfg, seed=0):
    """The JAX init exactly as `train_routine_fused` draws it."""
    _, k_init = jax.random.split(jax.random.PRNGKey(seed))
    return jm.init_params(k_init, cfg)


def _to_torch(pj):
    return tm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _to_jax(pt):
    return tm.tree_map(lambda t: jnp.asarray(t.detach().cpu().numpy()), pt)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves_with_path(t, path + (i,))
    else:
        yield path, tree


def _gn_cancelled(path):
    """Conv biases feed a GraphNorm whose mean_scale starts at 1, which
    subtracts them exactly: at init their gradient is 0 up to f32 noise."""
    return path[0] in ("conv1", "conv2", "conv2r") and path[-1] == "b"


def _assert_trees_close(pt, pj, rtol, atol, cancelled_atol=None):
    """Leaf for leaf; with `cancelled_atol`, the `_gn_cancelled` leaves are
    held to that absolute bound instead (their values are f32 noise)."""
    lt = dict(_leaves_with_path(
        tm.tree_map(lambda t: t.detach().cpu().numpy(), pt)))
    lj = dict(_leaves_with_path(pj))
    assert lt.keys() == lj.keys()
    for path, ref in lj.items():
        if cancelled_atol is not None and _gn_cancelled(path):
            np.testing.assert_allclose(lt[path], np.asarray(ref), rtol=0,
                                       atol=cancelled_atol, err_msg=str(path))
        else:
            np.testing.assert_allclose(lt[path], np.asarray(ref), rtol=rtol,
                                       atol=atol, err_msg=str(path))


class TestConfig:
    def test_fields_and_defaults_match(self):
        cj = jm.TwoWLConfig(max_degree=10)
        ct = tm.TwoWLConfig(max_degree=10)
        names = {f.name for f in dataclasses.fields(ct)}
        assert names == {f.name for f in dataclasses.fields(cj)} - {
            "pallas_interpret"}
        for name in names:
            assert getattr(ct, name) == getattr(cj, name), name

    def test_rejects_unported_options(self):
        assert tm.TwoWLConfig(max_degree=3,
                              compute_dtype="bf16").compute_dtype == "bf16"
        with pytest.raises(ValueError):
            tm.TwoWLConfig(max_degree=3, compute_dtype="f16")
        with pytest.raises(ValueError):
            tm.TwoWLConfig(max_degree=3, agg_1wl="pallas")


class TestSplitArrays:
    @pytest.mark.parametrize("which", ["toy_data", "fb_data"])
    def test_structures_equal(self, which, request):
        d = request.getfixturevalue(which)
        for s in (d.train, d.val, d.test):
            aj = jm.SplitArrays.from_split(s)
            at = tm.SplitArrays.from_split(s, "cpu")
            assert at.num_rows % 2 == 0 and at.num_msg == s.num_msg
            np.testing.assert_array_equal(at.msg_src_s.numpy(),
                                          np.asarray(aj.msg_src)[s.msg_perm])
            np.testing.assert_array_equal(at.msg_dst_s.numpy(),
                                          np.asarray(aj.msg_dst)[s.msg_perm])
            for a, b in zip(at.msg_plan[:2], aj.msg_plan[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            for a, b in zip(at.msg_plan[2], aj.msg_plan[2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert at.msg_slots.dtype == torch.int32
            np.testing.assert_array_equal(at.msg_slots.numpy(),
                                          np.asarray(aj.msg_slots))
            np.testing.assert_array_equal(at.msg_sweight.numpy(),
                                          np.asarray(aj.msg_svalid))
            # both composed structures (fwd from src1 = a^1, bwd transpose)
            for ops_t, ops_j in zip(at.e1_cops, aj.e1_cops):
                np.testing.assert_array_equal(ops_t[0].numpy(),
                                              np.asarray(ops_j[0]))
                assert len(ops_t[1]) == len(ops_j[1])
                for a, b in zip(ops_t[1], ops_j[1]):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_swap_is_parity_partner(self):
        r = torch.arange(12)
        np.testing.assert_array_equal(tm._swap(r).numpy(), np.arange(12) ^ 1)
        v = torch.arange(24.0).reshape(12, 2)
        np.testing.assert_array_equal(tm._swap(v).numpy(),
                                      v.numpy()[np.arange(12) ^ 1])


class TestLayers:
    def test_init_layout_and_params_from_jax(self):
        cj = jm.TwoWLConfig(max_degree=9, depth1=3, depth2=1)
        ct = tm.TwoWLConfig(max_degree=9, depth1=3, depth2=1)
        pj = jm.init_params(jax.random.PRNGKey(0), cj)
        pt = tm.init_params(ct, torch.Generator().manual_seed(0), "cpu")
        shapes_j = jax.tree_util.tree_map(lambda a: a.shape, pj)
        shapes_t = tm.tree_map(lambda t: tuple(t.shape), pt)
        assert jax.tree_util.tree_structure(shapes_t) == \
            jax.tree_util.tree_structure(shapes_j)
        assert jax.tree_util.tree_leaves(shapes_t) == \
            jax.tree_util.tree_leaves(shapes_j)
        assert all(t.requires_grad for t in tm.tree_leaves(pt))
        _assert_trees_close(_to_torch(pj), pj, 0, 0)

    def test_graph_norm(self):
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((50, 4)) * 3 + 2).astype(np.float32)
        p = {k: rng.standard_normal(4).astype(np.float32)
             for k in ("weight", "bias", "mean_scale")}
        got = tm.graph_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x))
        ref = jm.graph_norm({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)

    def test_gcn_conv_all_aggregations(self, toy_data):
        from linkpred_tpu.ops.segment import SegmentPlan as JPlan
        from linkpred_tpu_torch.ops.segment import SegmentPlan as TPlan

        s = toy_data.train
        n = s.num_nodes
        rng = np.random.default_rng(1)
        src = s.msg[s.msg_perm, 0]
        dst = s.msg[s.msg_perm, 1]
        mask = rng.random(len(src)) < 0.8
        x = rng.standard_normal((n, 5)).astype(np.float32)
        p = {"w": rng.standard_normal((5, 3)).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32)}
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        pt = {k: torch.from_numpy(v) for k, v in p.items()}
        jplan, tplan = JPlan.build(dst, n), TPlan.build(dst, n)
        ref = np.asarray(jm.gcn_conv(pj, jnp.asarray(x), jnp.asarray(src),
                                     jnp.asarray(dst), n, jnp.asarray(mask)))
        targs = (pt, torch.from_numpy(x), torch.from_numpy(src).long(),
                 torch.from_numpy(dst).long(), n, torch.from_numpy(mask))
        plan_ops = tplan.operands("cpu")
        for kw in ({}, {"plan": plan_ops},
                   {"plan": plan_ops, "ell": tplan.ell_operands("cpu")}):
            np.testing.assert_allclose(tm.gcn_conv(*targs, **kw).numpy(), ref,
                                       rtol=1e-5, atol=1e-6)
        slots, valid = jplan.ell_operands()
        ref_pallas = np.asarray(jm.gcn_conv(
            pj, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), n,
            jnp.asarray(mask), plan=jplan.operands(), ell=(slots, valid),
            backend="pallas", interpret=True))
        np.testing.assert_allclose(ref_pallas, ref, rtol=1e-5, atol=1e-6)

    def test_dropout_keep_rate_and_scale(self):
        g = torch.Generator().manual_seed(0)
        x = torch.ones(200_000)
        out = tm._dropout(g, x, 0.3)
        kept = out != 0
        assert abs(float(kept.float().mean()) - 0.7) < 0.005
        np.testing.assert_allclose(out[kept].numpy(), 1.0 / 0.7, rtol=1e-6)
        assert tm._dropout(g, x, 0.0) is x

    def test_double_index_and_sample_block_masks(self):
        np.testing.assert_array_equal(
            tm.double_index(torch.tensor([0, 3])).numpy(), [0, 1, 6, 7])
        msg_mask, ei2_m = tm.sample_block_masks(
            torch.tensor([0]), 8, torch.tensor([0, 1, 2, 4, 6, 0]),
            torch.tensor([True] * 5 + [False]))
        np.testing.assert_array_equal(msg_mask.numpy(), [False, False] + [True] * 6)
        np.testing.assert_array_equal(ei2_m.numpy(),
                                      [False, False, True, True, True, False])


class TestForward:
    def test_eval_and_grads_match_toy(self, toy_data):
        """K1 path ('ell') against the JAX Pallas path on the toy graph:
        eval scores, and forward + gradients under a sample-block mask."""
        d = toy_data
        cj, ct = _cfgs(d, channels_1wl=8, channels_2wl=8, depth1=2, depth2=2,
                       **NO_DROP)
        pj = _jax_init(cj)
        pt = _to_torch(pj)
        deg = np.asarray(d.node_deg)
        ref = np.asarray(jm.eval_scores(
            pj, jnp.asarray(deg), jm.SplitArrays.from_split(d.test), cfg=cj,
            num_nodes=d.num_nodes))
        got = tm.eval_scores(pt, torch.from_numpy(deg).long(),
                             tm.SplitArrays.from_split(d.test, "cpu"), ct)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)

        s = d.train
        rem = np.zeros(s.num_msg, bool)
        ids = np.random.default_rng(7).choice(s.num_msg // 2, 4, replace=False)
        rem[2 * ids] = rem[2 * ids + 1] = True
        sel = np.arange(12, dtype=np.int32)
        aj = jm.SplitArrays.from_split(s)

        def loss_j(p):
            return jnp.sum(jm.forward(p, cj, jnp.asarray(deg), aj,
                                      jnp.asarray(~rem), jnp.asarray(sel)) ** 2)

        lj, gj = jax.jit(jax.value_and_grad(loss_j))(pj)
        lt = torch.sum(tm.forward(pt, ct, torch.from_numpy(deg).long(),
                                  tm.SplitArrays.from_split(s, "cpu"),
                                  torch.from_numpy(~rem),
                                  torch.from_numpy(sel).long()) ** 2)
        lt.backward()
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
        scale = max(float(jnp.abs(g).max()) for g in jax.tree_util.tree_leaves(gj))
        _assert_trees_close(tm.tree_map(lambda t: t.grad, pt), gj,
                            rtol=1e-4, atol=1e-6 * scale,
                            cancelled_atol=1e-5 * scale)

    def test_eval_matches_fb_published_best(self, fb_data):
        d = fb_data
        cj, ct = _cfgs(d, ell=False)
        pj = _jax_init(cj)
        ref = np.asarray(jm.eval_scores(
            pj, jnp.asarray(d.node_deg), jm.SplitArrays.from_split(d.val),
            cfg=cj, num_nodes=d.num_nodes))
        ct = dataclasses.replace(ct, agg_1wl="ell")
        got = tm.eval_scores(_to_torch(pj),
                             torch.from_numpy(d.node_deg).long(),
                             tm.SplitArrays.from_split(d.val, "cpu"), ct)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


class TestTraining:
    def test_one_train_step_matches(self, toy_data):
        """One masked train step (K1 vs the Pallas kernel) under SGD, whose
        update keeps f32 gradient noise at noise size, as the reference's
        own backend test does."""
        d = toy_data
        cj, ct = _cfgs(d, channels_1wl=8, channels_2wl=8, depth1=2, depth2=1,
                       **NO_DROP)
        pj = _jax_init(cj)
        pt = _to_torch(pj)
        opt_j = optax.sgd(0.02)
        P = min(6, d.train.num_msg // 2, len(d.train.pred) // 2)
        pos = np.arange(P, dtype=np.int32)
        neg = np.arange(1, P + 1, dtype=np.int32)
        pj2, _, lj, _, _ = jm.train_step(
            pj, opt_j.init(pj), jax.random.PRNGKey(3), jnp.asarray(pos),
            jnp.asarray(neg), jm.SplitArrays.from_split(d.train), cfg=cj,
            optimizer=opt_j, num_nodes=d.num_nodes)
        lt, _, y = tm.train_step(
            pt, torch.optim.SGD(tm.tree_leaves(pt), lr=0.02), None,
            torch.from_numpy(pos).long(), torch.from_numpy(neg).long(),
            tm.SplitArrays.from_split(d.train, "cpu"), ct, d.num_nodes)
        assert y.tolist() == [1.0] * P + [0.0] * P
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        _assert_trees_close(pt, pj2, rtol=1e-4, atol=1e-6)

    def test_adam_matches_optax(self):
        """`tm.adam` is optax's `adam` step for step on the same gradients."""
        cj = jm.TwoWLConfig(max_degree=5, depth1=1, depth2=1)
        pj = jm.init_params(jax.random.PRNGKey(0), cj)
        pt = _to_torch(pj)
        opt_j = optax.adam(0.01)
        state = opt_j.init(pj)
        update = jax.jit(opt_j.update)
        opt_t = tm.adam(pt, 0.01)
        rng = np.random.default_rng(0)
        for _ in range(3):
            g = jax.tree_util.tree_map(
                lambda a: (rng.standard_normal(a.shape)
                           * 10.0 ** rng.integers(-6, 1)).astype(np.float32),
                pj)
            upd, state = update(g, state, pj)
            pj = jax.jit(optax.apply_updates)(pj, upd)
            tm.tree_map(lambda leaf, gl: setattr(leaf, "grad",
                                                 torch.from_numpy(gl)), pt, g)
            opt_t.step()
        # the two write the bias correction in algebraically equal forms:
        # f32 rounding moves a step of size lr = 1e-2 by ~1e-7
        _assert_trees_close(pt, pj, rtol=1e-5, atol=1e-6)

    def test_fused_routine_matches_jax_fb(self, fb_data):
        """10 epochs at the published-best widths, dropouts 0, lr 1e-3 (a
        value of the search space): loss and val AUC per epoch, best val and
        test AUC against the JAX train_scan.

        Why not lr 1e-2: the conv biases have f32-noise gradients
        (`_gn_cancelled`), which Adam turns into lr-size steps, and their
        effect grows as lr squared. At lr 1e-2 even the JAX package's own
        'plan' and 'pallas' paths differ by 2.2e-3 in loss after 10 epochs;
        at 1e-3 by 4e-6 (both measured on this input). An AUC moves by
        1/(208 * 208) = 2.3e-5 for each pair of near-tied logits that swap
        order, so AUCs are held to atol 2.5e-4 (ten swaps).
        """
        d = fb_data
        cj, ct = _cfgs(d, ell=False, learning_rate=1e-3, **NO_DROP)
        ct = dataclasses.replace(ct, agg_1wl="ell")
        E = 10
        run_t = tp.TwoWLRunConfig(epochs=E)
        pj = _jax_init(cj)
        pos, neg = tp.batch_schedule(d, run_t)
        # the schedule as the JAX pipeline draws it
        rng = np.random.default_rng(0)
        npp, nnp = d.train.num_msg // 2, len(d.train.pred) // 2
        P = min(len(d.val.y), npp, nnp)
        np.testing.assert_array_equal(
            pos, np.stack([rng.permutation(npp)[:P] for _ in range(E)]))
        np.testing.assert_array_equal(
            neg, np.stack([rng.permutation(nnp)[:P] for _ in range(E)]))

        opt = optax.adam(cj.learning_rate)
        _, _, best_pj, best_aj, _, (loss_j, auc_j) = jm.train_scan(
            pj, opt.init(pj), jax.random.PRNGKey(1), jnp.asarray(pos),
            jnp.asarray(neg), jm.SplitArrays.from_split(d.train),
            jm.SplitArrays.from_split(d.val), jnp.asarray(d.val.y),
            jnp.asarray(d.node_deg), cj, opt, d.num_nodes, E, early_stop=800)
        test_j, _ = jp.evaluate(best_pj, cj, d, d.test)

        res = tp.train_routine_fused(d, ct, run_t, "cpu",
                                     params=_to_torch(pj))
        loss_j, auc_j = np.asarray(loss_j), np.asarray(auc_j)
        np.testing.assert_allclose(res["loss_history"], loss_j, rtol=1e-4)
        np.testing.assert_allclose(res["best_val"], float(best_aj), rtol=1e-4)
        np.testing.assert_allclose(res["history"], auc_j, rtol=0, atol=2.5e-4)
        np.testing.assert_allclose(res["test_auc"], test_j, rtol=0, atol=2.5e-4)
        assert res["epochs_run"] == E

    def test_published_best_fb_5_epochs(self, fb_data):
        """The slice's configuration (reference dropouts, K1 aggregation):
        the run is sane, and its best params score the test split as the
        JAX package scores them."""
        d = fb_data
        cj, ct = _cfgs(d, ell=False)
        ct = dataclasses.replace(ct, agg_1wl="ell")
        res = tp.train_routine_fused(d, ct, tp.TwoWLRunConfig(epochs=5), "cpu")
        assert np.isfinite(res["loss_history"]).all()
        assert res["history"].shape == (5,)
        assert res["best_val"] == pytest.approx(float(res["history"].max()))
        ref = np.asarray(jm.eval_scores(
            _to_jax(res["params"]), jnp.asarray(d.node_deg),
            jm.SplitArrays.from_split(d.test), cfg=cj, num_nodes=d.num_nodes))
        assert res["test_auc"] == pytest.approx(roc_auc_score(d.test.y, ref),
                                                abs=1e-6)

    def test_early_stop_is_epoch_exact(self, toy_data):
        d = toy_data
        _, ct = _cfgs(d, channels_1wl=8, channels_2wl=8, depth1=1, depth2=1,
                      learning_rate=0.02, **NO_DROP)
        E, STOP = 40, 3
        pos, neg = (torch.from_numpy(a).long() for a in
                    tp.batch_schedule(d, tp.TwoWLRunConfig(epochs=E)))
        trn = tm.SplitArrays.from_split(d.train, "cpu")
        val = tm.SplitArrays.from_split(d.val, "cpu")
        args = (trn, val, torch.from_numpy(d.val.y),
                torch.from_numpy(d.node_deg).long(), ct, d.num_nodes)

        def run(early_stop):
            p = tm.init_params(ct, torch.Generator().manual_seed(0), "cpu")
            return tm.train_loop(p, tm.adam(p, ct.learning_rate), None, pos,
                                 neg, *args, early_stop=early_stop)

        *_, (_, aucs_free) = run(None)
        _, best, since, (losses, aucs) = run(STOP)
        best_a, streak, stop_at = -1.0, 0, E
        for i, a in enumerate(aucs_free.tolist()):
            if a > best_a:
                best_a, streak = a, 0
            else:
                streak += 1
            if streak > STOP:
                stop_at = i + 1
                break
        assert stop_at < E
        np.testing.assert_allclose(aucs[:stop_at].numpy(),
                                   aucs_free[:stop_at].numpy(), rtol=1e-6)
        assert (aucs[stop_at:] == -1.0).all() and (losses[stop_at:] == 0).all()
        assert int(since) == STOP + 1 + (E - stop_at)


class TestBf16AndUnpaired:
    """`compute_dtype='bf16'` and the unpaired 2-WL branch of `forward`."""

    def _setup(self, d, **kw):
        arch = dict(channels_1wl=8, channels_2wl=8, depth1=1, depth2=2)
        cj, ct = _cfgs(d, ell=False, **arch, **NO_DROP, **kw)
        pj = jm.init_params(jax.random.PRNGKey(0), cj)
        msg_mask = np.ones(d.train.num_msg, bool)
        msg_mask[[2, 3, 10, 11]] = False  # two removed pairs
        sel = np.arange(8)
        return cj, ct, pj, msg_mask, sel

    @pytest.mark.parametrize("agg", ["ell", "plan"])
    def test_bf16_forward_close_to_jax_and_f32(self, toy_data, agg):
        """The bar of the JAX package's own bf16 test: the largest
        difference under 0.05 of the largest f32 logit, against the JAX
        bf16 forward (whose bucket-sum adds in bf16, the port's in f32) and
        against the port's f32 forward."""
        d = toy_data
        cj, ct, pj, msg_mask, sel = self._setup(d)
        ct = dataclasses.replace(ct, agg_1wl=agg)
        deg = d.node_deg
        l16_j = np.asarray(jm.forward(
            pj, dataclasses.replace(cj, compute_dtype="bf16"),
            jnp.asarray(deg), jm.SplitArrays.from_split(d.train),
            jnp.asarray(msg_mask), jnp.asarray(sel), None))
        at = tm.SplitArrays.from_split(d.train, "cpu")
        args = (torch.from_numpy(deg).long(), at, torch.from_numpy(msg_mask),
                torch.from_numpy(sel))
        with torch.no_grad():
            l32 = tm.forward(_to_torch(pj), ct, *args).numpy()
            l16 = tm.forward(
                _to_torch(pj), dataclasses.replace(ct, compute_dtype="bf16"),
                *args)
        assert l16.dtype == torch.float32  # the head runs in f32
        l16 = l16.numpy()
        scale = np.abs(l32).max() + 1e-9
        assert np.abs(l16 - l16_j).max() / scale < 0.05
        assert np.abs(l16 - l32).max() / scale < 0.05
        assert np.abs(l16 - l32).max() > 0  # it did run in another dtype

    def test_bf16_gradients_flow_and_stay_f32(self, toy_data):
        d = toy_data
        _, ct, pj, msg_mask, sel = self._setup(d)
        ct = dataclasses.replace(ct, agg_1wl="ell", compute_dtype="bf16")
        pt = _to_torch(pj)
        logits = tm.forward(
            pt, ct, torch.from_numpy(d.node_deg).long(),
            tm.SplitArrays.from_split(d.train, "cpu"),
            torch.from_numpy(msg_mask), torch.from_numpy(sel))
        logits.square().sum().backward()
        for leaf in tm.tree_leaves(pt):
            assert leaf.grad is not None and leaf.grad.dtype == torch.float32
            assert torch.isfinite(leaf.grad).all()
        assert float(pt["conv2"][0]["w"].grad.abs().max()) > 0

    @pytest.mark.parametrize("which", ["toy_data", "fb_data"])
    def test_unpaired_matches_jax_unpaired_and_paired(self, which, request):
        d = request.getfixturevalue(which)
        cj, ct, pj, msg_mask, sel = self._setup(d)
        s = d.val
        msg_mask = msg_mask[:s.num_msg] if len(msg_mask) > s.num_msg else \
            np.concatenate([msg_mask, np.ones(s.num_msg - len(msg_mask),
                                              bool)])
        sel = s.num_msg + np.arange(len(s.pos1) - s.num_msg)
        aj = jm.SplitArrays.from_split(s)._replace(e1_cops=(), e2_cops=())
        ref = np.asarray(jm.forward(
            pj, cj, jnp.asarray(d.node_deg), aj, jnp.asarray(msg_mask),
            jnp.asarray(sel), None))
        unpaired = tm.SplitArrays.from_split(s, "cpu", paired=False)
        paired = tm.SplitArrays.from_split(s, "cpu")
        assert unpaired.e1_cops == () and paired.e1_src is None
        assert paired.e1_plan == () and len(unpaired.e2_plan) == 3
        common = (torch.from_numpy(d.node_deg).long(),)
        tail = (torch.from_numpy(msg_mask), torch.from_numpy(sel))
        with torch.no_grad():
            got = tm.forward(_to_torch(pj), ct, *common, unpaired, *tail)
            got_paired = tm.forward(_to_torch(pj), ct, *common, paired, *tail)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), got_paired.numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_unpaired_gradients_match_paired(self, toy_data):
        d = toy_data
        _, ct, pj, msg_mask, sel = self._setup(d)
        grads = []
        for paired in (False, True):
            pt = _to_torch(pj)
            tm.forward(pt, ct, torch.from_numpy(d.node_deg).long(),
                       tm.SplitArrays.from_split(d.train, "cpu",
                                                 paired=paired),
                       torch.from_numpy(msg_mask), torch.from_numpy(sel)
                       ).square().sum().backward()
            grads.append([leaf.grad for leaf in tm.tree_leaves(pt)])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


class TestTrainLoopOptions:
    """`eval_every`, `init_best`, the learning-rate schedule and the
    unfused routine."""

    def _inputs(self, d, E, **kw):
        cj, ct = _cfgs(d, ell=False, channels_1wl=8, channels_2wl=8,
                       depth1=1, depth2=1, learning_rate=1e-3, **NO_DROP, **kw)
        pos, neg = tp.batch_schedule(d, tp.TwoWLRunConfig(epochs=E))
        return cj, ct, pos, neg

    def test_eval_every_and_init_best_match_train_scan(self, toy_data):
        """Two calls of 8 epochs with `eval_every=4`, the second seeded by
        the first's best: -1 markers, the best AUC and the since-best count
        where the JAX `train_scan` puts them, and one call of 16 gives the
        same."""
        d = toy_data
        E, half = 16, 8
        cj, ct, pos, neg = self._inputs(d, E)
        pj = _jax_init(cj)
        opt = optax.adam(cj.learning_rate)
        trn_j, val_j = (jm.SplitArrays.from_split(s) for s in (d.train, d.val))
        state, params_j = opt.init(pj), pj
        best_j, hist_j = None, []
        for start in (0, half):
            params_j, state, bp, ba, since_j, (loss_j, auc_j) = jm.train_scan(
                params_j, state, jax.random.PRNGKey(1),
                jnp.asarray(pos[start:start + half]),
                jnp.asarray(neg[start:start + half]), trn_j, val_j,
                jnp.asarray(d.val.y), jnp.asarray(d.node_deg), cj, opt,
                d.num_nodes, half, eval_every=4, init_best=best_j,
                early_stop=800)
            best_j = (bp, ba, since_j)
            hist_j.append((np.asarray(loss_j), np.asarray(auc_j)))

        trn, val = (tm.SplitArrays.from_split(s, "cpu")
                    for s in (d.train, d.val))
        args = (trn, val, torch.from_numpy(d.val.y),
                torch.from_numpy(d.node_deg).long(), ct, d.num_nodes)
        pos_t, neg_t = torch.from_numpy(pos).long(), torch.from_numpy(neg).long()

        def run(cuts):
            pt = _to_torch(pj)
            opt_t = tm.adam(pt, ct.learning_rate)
            best, hist = None, []
            for a, b in cuts:
                bp, ba, since, h = tm.train_loop(
                    pt, opt_t, None, pos_t[a:b], neg_t[a:b], *args,
                    early_stop=800, eval_every=4, init_best=best)
                best = (bp, ba, since)
                hist.append(h)
            return best, hist

        best, hist = run([(0, half), (half, E)])
        for (loss_t, auc_t), (loss_j, auc_j) in zip(hist, hist_j):
            np.testing.assert_allclose(loss_t.numpy(), loss_j, rtol=1e-4)
            marks = auc_j == -1.0
            assert marks.sum() == 6 and not marks[3] and not marks[7]
            np.testing.assert_array_equal(auc_t.numpy() == -1.0, marks)
            np.testing.assert_allclose(auc_t.numpy()[~marks], auc_j[~marks],
                                       rtol=0, atol=2.5e-4)
        assert int(best[2]) == int(best_j[2])
        np.testing.assert_allclose(float(best[1]), float(best_j[1]), rtol=0,
                                   atol=2.5e-4)
        # the GraphNorm-cancelled biases take a noise step of up to lr an
        # epoch in each package
        _assert_trees_close(best[0], best_j[0], rtol=1e-4, atol=1e-6,
                            cancelled_atol=2 * 1e-3 * E)
        whole, hist_w = run([(0, E)])
        assert int(whole[2]) == int(best[2])
        assert float(whole[1]) == float(best[1])
        torch.testing.assert_close(
            hist_w[0][1], torch.cat([h[1] for h in hist]), rtol=0, atol=0)

    def test_init_best_carries_since_into_early_stop(self, toy_data):
        d = toy_data
        _, ct, pos, neg = self._inputs(d, 6)
        pt = tm.init_params(ct, torch.Generator().manual_seed(0), "cpu")
        best0 = tm.tree_map(lambda p: p.detach().clone(), pt)
        _, best_a, since, (losses, aucs) = tm.train_loop(
            pt, tm.adam(pt, ct.learning_rate), None,
            torch.from_numpy(pos).long(), torch.from_numpy(neg).long(),
            tm.SplitArrays.from_split(d.train, "cpu"),
            tm.SplitArrays.from_split(d.val, "cpu"), torch.from_numpy(d.val.y),
            torch.from_numpy(d.node_deg).long(), ct, d.num_nodes,
            early_stop=3, init_best=(best0, 2.0, 2))
        # no AUC beats 2.0: epochs 0 and 1 run (since 2 -> 4), the rest freeze
        assert int(since) == 2 + 6 and float(best_a) == 2.0
        assert (losses[:2] > 0).all() and (losses[2:] == 0).all()
        assert (aucs[:2] >= 0).all() and (aucs[2:] == -1.0).all()

    def test_warmup_cosine_schedule_equals_optax(self):
        for init, peak, warm, decay, end in (
                (0.0005, 0.01, 10, 96, 0.0002), (0.0005, 0.01, 10, 11, 0.0002),
                (0.0, 0.05, 3, 40, 0.0), (0.001, 0.02, 0, 25, 0.001)):
            ref = optax.schedules.warmup_cosine_decay_schedule(
                init_value=init, peak_value=peak, warmup_steps=warm,
                decay_steps=decay, end_value=end)
            got = tm.warmup_cosine_schedule(init, peak, warm, decay, end)
            steps = np.arange(decay + 5)
            want = np.array([float(ref(int(k))) for k in steps])
            np.testing.assert_allclose(got(steps), want, rtol=0, atol=1e-8)
            assert float(got(7)) == got(steps)[7]

    def test_lr_schedule_is_adam_under_the_optax_schedule(self, toy_data):
        """Epoch k trains at schedule(k): four epochs under a warm-up cosine
        schedule against optax's Adam driven by the same schedule."""
        d = toy_data
        E = 4
        cj, ct, pos, neg = self._inputs(d, E)
        sched = optax.schedules.warmup_cosine_decay_schedule(
            init_value=5e-5, peak_value=1e-3, warmup_steps=2, decay_steps=E,
            end_value=2e-5)
        opt = optax.adam(sched)
        pj = _jax_init(cj)
        *_, (loss_j, _) = jm.train_scan(
            pj, opt.init(pj), jax.random.PRNGKey(1), jnp.asarray(pos),
            jnp.asarray(neg), jm.SplitArrays.from_split(d.train),
            jm.SplitArrays.from_split(d.val), jnp.asarray(d.val.y),
            jnp.asarray(d.node_deg), cj, opt, d.num_nodes, E)
        pt = _to_torch(pj)
        lrs = tm.warmup_cosine_schedule(5e-5, 1e-3, 2, E, 2e-5)(np.arange(E))
        optimizer = tm.adam(pt, 123.0)  # overwritten before every step
        *_, (loss_t, _) = tm.train_loop(
            pt, optimizer, None, torch.from_numpy(pos).long(),
            torch.from_numpy(neg).long(),
            tm.SplitArrays.from_split(d.train, "cpu"),
            tm.SplitArrays.from_split(d.val, "cpu"), torch.from_numpy(d.val.y),
            torch.from_numpy(d.node_deg).long(), ct, d.num_nodes,
            lr_schedule=lrs)
        assert optimizer.param_groups[0]["lr"] == lrs[-1]
        np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                                   rtol=1e-4)

    def test_train_routine_equals_fused(self, fb_data):
        """The per-epoch host loop and the fused loop over 5 epochs at lr
        1e-3, reference dropouts, on the fused loop's batch schedule: the
        same losses, and the same val AUCs and test AUC of the best epoch
        up to tie handling."""
        d = fb_data
        ct = tm.TwoWLConfig(max_degree=d.max_degree, learning_rate=1e-3,
                            agg_1wl="ell")
        run = tp.TwoWLRunConfig(epochs=5)
        fused = tp.train_routine_fused(d, ct, run, "cpu", seed=3)
        loop = tp.train_routine(d, ct, run, "cpu", seed=3,
                                schedule=tp.batch_schedule(d, run))
        np.testing.assert_allclose(loop["loss_history"],
                                   fused["loss_history"], rtol=1e-6)
        # the host loop ranks sigmoid scores in numpy (ties share a rank),
        # the fused loop ranks logits on the device (ties take the lower
        # rank), and near-equal logits can round to one f32 score: the AUCs
        # may differ by the order of two (positive, negative) pairs
        def two_pairs(y):
            return 2.0 / (float(y.sum()) * float((1 - y).sum()))

        np.testing.assert_allclose(loop["history"], fused["history"],
                                   rtol=0, atol=two_pairs(d.val.y))
        assert loop["best_val"] == pytest.approx(fused["best_val"],
                                                 abs=two_pairs(d.val.y))
        assert loop["test_auc"] == pytest.approx(fused["test_auc"],
                                                 abs=two_pairs(d.test.y))
        assert loop["fpr"][0] == 0.0 and loop["tpr"][-1] == 1.0
        # without a schedule it draws as the reference's loop: positives and
        # negatives of an epoch in turn from one stream
        own = tp.train_routine(d, ct, tp.TwoWLRunConfig(epochs=2), "cpu",
                               seed=3)
        assert own["history"].shape == (2,)
        assert own["loss_history"][0] != fused["loss_history"][0]


class TestPipeline:
    def test_search_space_and_trials_match(self):
        assert tp.SEARCH_SPACE == jp.SEARCH_SPACE
        a, b = np.random.default_rng(4), np.random.default_rng(4)
        for _ in range(5):
            assert tp.sample_trial(a) == jp.sample_trial(b)

    def test_run_twowl_outputs_and_resume(self, tmp_path):
        out = {
            "log_file": str(tmp_path / "logs.json"),
            "state_file": str(tmp_path / "state.jsonl"),
            "roc_dir": str(tmp_path),
            "metrics_file": str(tmp_path / "logs" / "metrics.jsonl"),
            "roc_png": str(tmp_path / "img" / "twowl_roc.png"),
            "checkpoint_path": str(tmp_path / "ckpt" / "model"),
        }
        run = tp.TwoWLRunConfig(epochs=2, records_dir=str(tmp_path / "rec"))
        res = tp.run_twowl(run, n_trials=2, device="cpu", verbose=False, **out)
        assert os.path.getsize(out["roc_png"]) > 0
        # the winner's parameters: the embedding table and its GraphNorm,
        # 5 leaves a conv layer, the head
        hp = res["best_params"]
        saved = np.load(out["checkpoint_path"] + ".npz")
        assert len(saved.files) == 4 + 5 * (hp["depth1"] + 2 * hp["depth2"]) + 2
        assert all(np.isfinite(saved[k]).all() for k in saved.files)
        meta = json.loads((tmp_path / "ckpt" / "model.tree.json").read_text())
        assert meta["num_leaves"] == len(saved.files)
        rec = tmp_path / "rec" / "fb-pages-food_auc_record_twowl.txt"
        lines = rec.read_text().splitlines(keepends=True)
        assert len(lines) == 2
        assert all(ln.startswith("AUC:") and ln.endswith("   \n")
                   for ln in lines)
        assert len((tmp_path / "state.jsonl").read_text().splitlines()) == 2
        best = json.loads((tmp_path / "logs.json").read_text())
        assert best == res["best_params"] and set(best) == set(tp.SEARCH_SPACE)
        fpr = json.loads((tmp_path / "fpr.json").read_text())
        assert fpr[0] == 0.0 and fpr[-1] == 1.0
        assert os.path.exists(out["metrics_file"])

        # a second call replays both trials from the journal and keeps them
        again = tp.run_twowl(run, n_trials=2, device="cpu", verbose=False,
                             **out)
        assert [t["val"] for t in again["trials"]] == [
            t["val"] for t in res["trials"]]
        assert rec.read_text().splitlines(keepends=True) == lines

    def test_cli_parses_twowl(self):
        args = cli.build_parser().parse_args(
            ["--seed", "3", "--quiet", "twowl", "--epochs", "7",
             "--trials", "2"])
        assert (args.seed, args.quiet, args.cmd, args.epochs, args.trials) == (
            3, True, "twowl", 7, 2)
