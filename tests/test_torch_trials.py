"""Parity of the port's trial-major TwoWL sweep with the JAX package.

Inputs are made with numpy from a seed and the JAX package's initial
parameters are loaded into the port (`params_from_jax`); dropouts are 0
wherever values are compared. The port runs 'ell' where noted: on CPU
tensors kernels K1 and K3 run their plain versions (`spmm_ell_reference`,
`spmm_bucketed_reference`), so these tests hold their operand layouts
against the JAX package; 'plan' runs the plain bucket-sums. A 40-node toy
graph with channels 8/8, depths 2/2 and T = 3 trials unless noted.

Tolerances: host structures and index layouts array-equal; AUCs atol 1e-6;
the composed gather-sum at fb-pages-food scale atol 1e-5 (f32 sums of up to
115 terms in another order); forward logits rtol/atol 1e-5; gradients rtol
1e-4 with atol 1e-6 of the largest gradient (1e-5 for the conv biases that
GraphNorm cancels, whose gradients are f32 noise); Adam on shared gradients
rtol 1e-5, atol 1e-6; ten training epochs at lr 1e-3 losses rtol 1e-3.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from linkpred_tpu.data import io
from linkpred_tpu.data import twowl as dt
from linkpred_tpu.models import twowl as jm
from linkpred_tpu.ops import segment as jseg
from linkpred_tpu.pipelines import twowl_pipeline as jp
from linkpred_tpu.utils.metrics import roc_auc_trials as jax_roc_auc_trials
from linkpred_tpu_torch import cli
from linkpred_tpu_torch.models import twowl as tm
from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops import segment as tseg
from linkpred_tpu_torch.pipelines import twowl_pipeline as tp
from linkpred_tpu_torch.utils.metrics import roc_auc_trials

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

T = 3
TOY = dict(channels_1wl=8, channels_2wl=8, depth1=2, depth2=2)
NO_DROP = dict(dp_emb=0.0, dp_1wl0=0.0, dp_1wl1=0.0, dp_2wl=0.0)


@pytest.fixture(scope="module")
def toy_data():
    rng = np.random.default_rng(0)
    n = 40
    pairs = np.stack([rng.integers(0, n, 160), rng.integers(0, n, 160)], 1)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return dt.build_twowl_data(pairs, n, rng=rng)


@pytest.fixture(scope="module")
def fb_data():
    _, edges = io.load_fb_pages_food()
    return dt.build_twowl_data(edges, int(edges.max()) + 1,
                               rng=np.random.default_rng(0))


def _cfgs(d, agg="ell", **kw):
    """(JAX config on 'plan', port config on `agg`) of one architecture."""
    kw = {**TOY, **kw}
    return (jm.TwoWLConfig(max_degree=d.max_degree, **kw),
            tm.TwoWLConfig(max_degree=d.max_degree, agg_1wl=agg, **kw))


def _to_torch(pj):
    return tm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")


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
    subtracts them exactly: their gradient is 0 up to f32 noise."""
    return path[0] in ("conv1", "conv2", "conv2r") and path[-1] == "b"


def _assert_trees_close(pt, pj, rtol, atol, cancelled_atol=None):
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


def _eval_inputs(s):
    """(msg_mask, selected rows) scoring every prediction pair of split s."""
    sel = s.num_msg + np.arange(len(s.pred), dtype=np.int32)
    return np.ones(s.num_msg, bool), sel


def _zero_rates_j():
    return jm.TrialRates(*[jnp.zeros((T,), jnp.float32)] * 4)


def _zero_rates_t():
    return tm.TrialRates(*[torch.zeros(T)] * 4)


# ---------------------------------------------------------------------------
# metrics, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [5, 1000])
def test_roc_auc_trials_matches_jax(levels):
    """Few score levels give many ties, which the double stable argsort
    ranks in sample order on both sides."""
    rng = np.random.default_rng(levels)
    y = (rng.random(300) < 0.4).astype(np.float32)
    scores = rng.integers(0, levels, (300, 7)).astype(np.float32)
    got = roc_auc_trials(torch.from_numpy(y), torch.from_numpy(scores))
    ref = jax_roc_auc_trials(jnp.asarray(y), jnp.asarray(scores))
    assert got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_init_params_trials_layout_and_params_from_jax(toy_data):
    cj, ct = _cfgs(toy_data)
    pj = jm.init_params_trials(jax.random.PRNGKey(0), cj, T)
    pt = tm.init_params_trials(ct, T, torch.Generator().manual_seed(0), "cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, pj)
    shapes_t = tm.tree_map(lambda t: tuple(t.shape), pt)
    assert jax.tree_util.tree_structure(shapes_t) == \
        jax.tree_util.tree_structure(shapes_j)
    assert jax.tree_util.tree_leaves(shapes_t) == \
        jax.tree_util.tree_leaves(shapes_j)
    assert pt["emb"].shape == (cj.max_degree + 1, T, cj.channels_1wl)
    assert all(t.requires_grad and t.is_contiguous()
               for t in tm.tree_leaves(pt))
    # the trials are independent draws
    assert not torch.equal(pt["conv1"][0]["w"][0], pt["conv1"][0]["w"][1])
    _assert_trees_close(_to_torch(pj), pj, 0, 0)


def test_extract_and_take_trials_match_jax(toy_data):
    cj, _ = _cfgs(toy_data)
    pj = jm.init_params_trials(jax.random.PRNGKey(1), cj, T)
    pt = _to_torch(pj)
    for i in range(T):
        _assert_trees_close(tm.extract_trial(pt, i), jm.extract_trial(pj, i),
                            0, 0)
    idx = np.array([2, 0])
    taken = tm.take_trials(pt, idx)
    _assert_trees_close(taken, jm.take_trials(pj, jnp.asarray(idx)), 0, 0)
    assert all(t.requires_grad and t.is_leaf for t in tm.tree_leaves(taken))


def test_dropout_trials_keeps_each_trials_rate():
    g = torch.Generator().manual_seed(0)
    rates = torch.tensor([0.0, 0.3, 0.5])
    out = tm._dropout_trials(g, torch.ones((40_000, 3, 4)), rates)
    for t, r in enumerate(rates.tolist()):
        kept = out[:, t] != 0
        assert abs(float(kept.float().mean()) - (1.0 - r)) < 0.01
        np.testing.assert_allclose(out[:, t][kept].numpy(), 1.0 / (1.0 - r),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the aggregations in the trial-major layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", [0, 1], ids=["forward", "transpose"])
def test_k3_composed_operands_equal_jax_buckets(fb_data, direction):
    """K3's layout of both composed structures of every fb-pages-food split
    is the JAX package's buckets, concatenated in order."""
    for s in (fb_data.train, fb_data.val, fb_data.test):
        ops_j = jm.SplitArrays.from_split(s).e1_cops[direction]
        ops_t = tm.SplitArrays.from_split(s, "cpu").e1_cops[direction]
        inv_perm, shapes, nbr, w, order = ops_t.k3
        assert inv_perm.dtype == nbr.dtype == torch.int32
        assert w.dtype == torch.float32
        assert all(a.is_contiguous() for a in (inv_perm, nbr, w))
        np.testing.assert_array_equal(inv_perm.numpy(), np.asarray(ops_j[0]))
        assert shapes == tuple(tuple(b.shape) for b in ops_j[1])
        np.testing.assert_array_equal(
            nbr.numpy(),
            np.concatenate([np.asarray(b).reshape(-1) for b in ops_j[1]]))
        assert (w == 1).all() and w.shape == nbr.shape
        # the launch order: a permutation of the rows, widest bucket first
        assert order.dtype == torch.int32 and order.is_contiguous()
        np.testing.assert_array_equal(np.sort(order.numpy()),
                                      np.arange(inv_perm.shape[0]))
        assert (np.diff(inv_perm.numpy()[order.numpy()]) <= 0).all()


@pytest.mark.parametrize("f", [32, 96])
def test_k3_composed_sum_matches_jax_fb_train(fb_data, f):
    """`spmm_bucketed_reference` on the forward and transpose operands is
    JAX `gather_sum_composed` and its VJP on the fb-pages-food train split;
    so is K3's route of the port (`_k3_sum`, which flattens trailing dims),
    and the port's `gather_sum_composed` on both routes (K3's plain version
    here, and the plain bucket-sum)."""
    s = fb_data.train
    fj, bj = jm.SplitArrays.from_split(s).e1_cops
    ft, bt = tm.SplitArrays.from_split(s, "cpu").e1_cops
    rng = np.random.default_rng(f)
    x = rng.standard_normal((s.num_rows, f)).astype(np.float32)
    cot = rng.standard_normal((s.num_rows, f)).astype(np.float32)
    out_j, vjp = jax.vjp(
        jax.jit(lambda v: jseg.gather_sum_composed(v, fj, bj)),
        jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(cot))
    out = hk.spmm_bucketed_reference(torch.from_numpy(x), *ft.k3)
    dx = hk.spmm_bucketed_reference(torch.from_numpy(cot), *bt.k3)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), rtol=0,
                               atol=1e-5)

    x3 = torch.from_numpy(x).reshape(s.num_rows, 2, f // 2)
    cot3 = torch.from_numpy(cot).reshape(x3.shape)
    for got, ref in ((tseg._k3_sum(x3, ft), out_j),
                     (tseg._k3_sum(cot3, bt), dx_j)):
        assert got.shape == x3.shape
        np.testing.assert_allclose(got.reshape(-1, f).numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-5)

    for kernel in (True, False):
        xt = x3.clone().requires_grad_()
        got = tseg.gather_sum_composed(xt, ft, bt, kernel=kernel)
        got.backward(cot3)
        np.testing.assert_allclose(got.detach().reshape(-1, f).numpy(),
                                   np.asarray(out_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(xt.grad.reshape(-1, f).numpy(),
                                   np.asarray(dx_j), rtol=0, atol=1e-5)


def test_segment_sum_ell_takes_trial_major_messages(toy_data):
    """K1's segment sum on [S, T, C] messages: forward and gradient equal
    the JAX planned segment sum on the same 3-D messages."""
    s = toy_data.train
    dst = s.msg[s.msg_perm][:, 1]
    n = s.num_nodes
    plan_t = tseg.SegmentPlan.build(dst, n)
    ops_j = jseg.SegmentPlan.build(dst, n).operands()
    rng = np.random.default_rng(3)
    msgs = rng.standard_normal((len(dst), T, 5)).astype(np.float32)
    cot = rng.standard_normal((n, T, 5)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda v: jseg.segment_sum_planned(n, v, *ops_j),
                         jnp.asarray(msgs))
    (g_j,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(msgs).requires_grad_()
    out = tseg.segment_sum_ell(n, x, plan_t.operands("cpu")[0],
                               *plan_t.ell_operands("cpu"))
    out.backward(torch.from_numpy(cot))
    assert out.shape == (n, T, 5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# forward, gradients, Adam, the epoch loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("agg", ["plan", "ell"])
def test_forward_trials_matches_jax_and_single(toy_data, agg):
    """Eval-mode logits of all trials against JAX `forward_trials` from the
    same parameters, and against the port's single-trial `forward` of each
    extracted trial."""
    d = toy_data
    cj, ct = _cfgs(d, agg)
    pj = jm.init_params_trials(jax.random.PRNGKey(0), cj, T)
    pt = _to_torch(pj)
    mask, sel = _eval_inputs(d.val)
    deg = np.asarray(d.node_deg)
    ref = np.asarray(jm.forward_trials(
        pj, cj, jnp.asarray(deg), jm.SplitArrays.from_split(d.val),
        jnp.asarray(mask), jnp.asarray(sel), None, None))
    args = (torch.from_numpy(deg).long(),
            tm.SplitArrays.from_split(d.val, "cpu"), torch.from_numpy(mask),
            torch.from_numpy(sel).long())
    with torch.no_grad():
        got = tm.forward_trials(pt, ct, *args)
        assert got.shape == (len(sel) // 2, T)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
        for i in range(T):
            single = tm.forward(tm.extract_trial(pt, i), ct, *args)
            np.testing.assert_allclose(got[:, i].numpy(), single.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_forward_trials_unpaired_matches_jax_and_paired(toy_data):
    """The unpaired branch of `forward_trials` (`from_split(...,
    paired=False)`) against the JAX unpaired branch (no `e1_cops`), against
    the port's paired branch and against the unpaired single-trial
    `forward` of each trial, under a mask that removes two pairs."""
    d = toy_data
    cj, ct = _cfgs(d, "plan")
    pj = jm.init_params_trials(jax.random.PRNGKey(0), cj, T)
    pt = _to_torch(pj)
    mask, sel = _eval_inputs(d.val)
    mask = mask.copy()
    mask[[4, 5, 8, 9]] = False
    deg = np.asarray(d.node_deg)
    aj = jm.SplitArrays.from_split(d.val)._replace(e1_cops=(), e2_cops=())
    ref = np.asarray(jm.forward_trials(
        pj, cj, jnp.asarray(deg), aj, jnp.asarray(mask), jnp.asarray(sel),
        None, None))
    unpaired = tm.SplitArrays.from_split(d.val, "cpu", paired=False)
    head = (torch.from_numpy(deg).long(),)
    tail = (torch.from_numpy(mask), torch.from_numpy(sel).long())
    with torch.no_grad():
        got = tm.forward_trials(pt, ct, *head, unpaired, *tail)
        paired = tm.forward_trials(
            pt, ct, *head, tm.SplitArrays.from_split(d.val, "cpu"), *tail)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), paired.numpy(), rtol=1e-5,
                                   atol=1e-5)
        single = tm.forward(tm.extract_trial(pt, 1), ct, *head, unpaired,
                            *tail)
        np.testing.assert_allclose(got[:, 1].numpy(), single.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_train_step_trials_grads_match_jax(toy_data, monkeypatch):
    """The gradients that `train_step_trials` hands to the per-trial Adam
    against `jax.grad` of the loss of JAX `train_step_trials` (the sum of
    the per-trial BCE losses) under the same sample-block mask."""
    d = toy_data
    cj, ct = _cfgs(d, **NO_DROP)
    pj = jm.init_params_trials(jax.random.PRNGKey(2), cj, T)
    pt = _to_torch(pj)
    P = min(6, d.train.num_msg // 2, len(d.train.pred) // 2)
    pos = torch.arange(P)
    neg = torch.arange(1, P + 1)
    arrays_t = tm.SplitArrays.from_split(d.train, "cpu")
    msg_mask, deg, sel, y = tm._step_inputs(pos, neg, arrays_t, ct,
                                            d.num_nodes)
    aj = jm.SplitArrays.from_split(d.train)

    def loss_j(p):
        logits = jm.forward_trials(
            p, cj, jnp.asarray(deg.numpy()), aj, jnp.asarray(msg_mask.numpy()),
            jnp.asarray(sel.numpy()), None, None)
        return optax.sigmoid_binary_cross_entropy(
            logits, jnp.asarray(y.numpy())[:, None]).mean(axis=0).sum()

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(pj)
    seen = {}
    monkeypatch.setattr(tm, "adam_trials_update",
                        lambda params, grads, state, lrs: seen.update(
                            grads=grads))
    losses = tm.train_step_trials(pt, tm.adam_trials_init(pt), None, pos, neg,
                                  arrays_t, ct, torch.full((T,), 1e-3),
                                  d.num_nodes, _zero_rates_t())
    assert losses.shape == (T,)
    np.testing.assert_allclose(float(losses.sum()), float(lj), rtol=1e-5)
    grads = iter(seen["grads"])
    gt = tm.tree_map(lambda _: next(grads), pt)
    scale = max(float(jnp.abs(g).max()) for g in jax.tree_util.tree_leaves(gj))
    _assert_trees_close(gt, gj, rtol=1e-4, atol=1e-6 * scale,
                        cancelled_atol=1e-5 * scale)


def test_adam_trials_matches_optax_with_lr_scaling(toy_data):
    """The per-trial Adam on shared gradients against optax `adam(1.0)`
    with its updates scaled by each trial's lr, as the JAX sweep runs it;
    then the moments sliced by `take_trials` as halving slices them."""
    cj, _ = _cfgs(toy_data)
    pj = jm.init_params_trials(jax.random.PRNGKey(0), cj, T)
    pt = _to_torch(pj)
    lrs = np.array([0.0005, 0.01, 0.05], np.float32)
    opt = optax.adam(1.0)
    state = opt.init(pj)
    st = tm.adam_trials_init(pt)
    axes = jm._trial_axes(pj)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape)
                       * 10.0 ** rng.integers(-6, 1)).astype(np.float32), pj)
        upd, state = opt.update(g, state, pj)
        upd = jax.tree_util.tree_map(
            lambda u, ax: u * jm._bcast_trial(jnp.asarray(lrs), u.ndim, ax),
            upd, axes)
        pj = optax.apply_updates(pj, upd)
        tm.adam_trials_update(
            pt, tm.tree_leaves(tm.tree_map(lambda p, gl: torch.from_numpy(gl),
                                           pt, g)),
            st, torch.from_numpy(lrs))
    assert st.count == 3
    _assert_trees_close(pt, pj, rtol=1e-5, atol=1e-6)
    _assert_trees_close(st.mu, state[0].mu, rtol=1e-5, atol=1e-7)
    _assert_trees_close(st.nu, state[0].nu, rtol=1e-5, atol=1e-12)
    keep = np.array([0, 2])
    _assert_trees_close(tm.take_trials(st.nu, keep),
                        jm.take_trials(state[0].nu, jnp.asarray(keep)),
                        rtol=1e-5, atol=1e-12)


def test_train_loop_trials_matches_train_scan_trials(toy_data):
    """Ten epochs at lr 1e-3 (dropouts 0) against the JAX
    `train_scan_trials` from the same parameters and batches: per-trial
    losses to rtol 1e-3, and the best val AUCs and their parameters."""
    d = toy_data
    cj, ct = _cfgs(d, **NO_DROP)
    E = 10
    pj = jm.init_params_trials(jax.random.PRNGKey(4), cj, T)
    pt = _to_torch(pj)
    pos, neg = tp.batch_schedule(d, tp.TwoWLRunConfig(epochs=E))
    lrs = np.full(T, 1e-3, np.float32)
    opt = optax.adam(1.0)
    _, _, best_pj, best_aj, (loss_j, auc_j) = jm.train_scan_trials(
        pj, opt.init(pj), jax.random.PRNGKey(1), jnp.asarray(pos),
        jnp.asarray(neg), jm.SplitArrays.from_split(d.train),
        jm.SplitArrays.from_split(d.val), jnp.asarray(d.val.y),
        jnp.asarray(d.node_deg), cj, opt, jnp.asarray(lrs), d.num_nodes, E,
        _zero_rates_j())
    best_pt, best_at, (loss_t, auc_t) = tm.train_loop_trials(
        pt, tm.adam_trials_init(pt), None, torch.from_numpy(pos).long(),
        torch.from_numpy(neg).long(), tm.SplitArrays.from_split(d.train, "cpu"),
        tm.SplitArrays.from_split(d.val, "cpu"), torch.from_numpy(d.val.y),
        torch.from_numpy(d.node_deg).long(), ct, torch.from_numpy(lrs),
        d.num_nodes, _zero_rates_t())
    assert loss_t.shape == auc_t.shape == (E, T)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-3)
    np.testing.assert_allclose(auc_t.numpy(), np.asarray(auc_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(best_at.numpy(), np.asarray(best_aj), rtol=0,
                               atol=1e-6)
    _assert_trees_close(best_pt, best_pj, rtol=1e-3, atol=1e-5,
                        cancelled_atol=5e-3)


# ---------------------------------------------------------------------------
# the refine sweeps and their entry points
# ---------------------------------------------------------------------------


class _Drawn(Exception):
    pass


@pytest.mark.parametrize("mode", ["flat", "halving", "adaptive"])
def test_refine_draws_match_jax(toy_data, mode, monkeypatch):
    """For one seed, each mode's first trial-major run gets the same lrs,
    dropout rates and batch schedule in both packages."""
    d = toy_data
    cj, ct = _cfgs(d)
    run_j = jp.TwoWLRunConfig(epochs=5, seed=3)
    run_t = tp.TwoWLRunConfig(epochs=5, seed=3)
    drawn = {}

    def capture_j(params, opt_state, key, pos, neg, trn, val, val_y, deg,
                  cfg, optimizer, lrs, num_nodes, num_epochs, rates, **_):
        drawn["jax"] = (lrs, rates, pos, neg)
        raise _Drawn

    def capture_t(params, opt_state, generator, pos, neg, trn, val, val_y,
                  deg, cfg, lrs, num_nodes, rates, **_):
        drawn["torch"] = (lrs, rates, pos, neg)
        raise _Drawn

    monkeypatch.setattr(jm, "train_scan_trials", capture_j)
    monkeypatch.setattr(tm, "train_loop_trials", capture_t)
    fn_j = {"flat": jp.refine_vmapped, "halving": jp.refine_halving,
            "adaptive": jp.refine_adaptive}[mode]
    with pytest.raises(_Drawn):
        fn_j(d, cj, run_j, n_trials=8)
    with pytest.raises(_Drawn):
        tp.REFINE_MODES[mode](d, ct, run_t, n_trials=8, device="cpu")
    (lr_j, rates_j, pos_j, neg_j), (lr_t, rates_t, pos_t, neg_t) = (
        drawn["jax"], drawn["torch"])
    np.testing.assert_array_equal(lr_t.numpy(), np.asarray(lr_j))
    for f in tm.TrialRates._fields:
        np.testing.assert_array_equal(getattr(rates_t, f).numpy(),
                                      np.asarray(getattr(rates_j, f)), f)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(neg_t.numpy(), np.asarray(neg_j))


def test_refine_vmapped_runs_and_selects(toy_data):
    _, ct = _cfgs(toy_data, depth1=1, depth2=1)
    res = tp.refine_vmapped(toy_data, ct, tp.TwoWLRunConfig(epochs=8),
                            n_trials=3, device="cpu")
    assert res["val_aucs"].shape == (3,)
    assert res["best_val"] == pytest.approx(res["val_aucs"].max())
    assert 0.0 <= res["test_auc"] <= 1.0
    assert set(res["winner"]) == {"lr", "dp_emb", "dp_1wl0", "dp_1wl1",
                                  "dp_2wl"}
    assert tm.tree_leaves(res["params"])[0].dim() == 2  # one trial's params


def test_refine_halving_prunes_warm(toy_data):
    """8 trials, rungs of 2 epochs over 6: 8 -> 4 -> 2 survivors."""
    _, ct = _cfgs(toy_data)
    res = tp.refine_halving(toy_data, ct, tp.TwoWLRunConfig(epochs=6),
                            n_trials=8, eta=2, min_trials=2, rung_epochs=2,
                            seed=3, device="cpu")
    assert res["configs_inspected"] == 8
    assert len(res["survivors"]) == 2 and res["survivors"] == sorted(
        res["survivors"])
    assert res["val_aucs"].shape == (2,)
    assert res["best_val"] == pytest.approx(res["val_aucs"].max())
    assert 0.0 <= res["test_auc"] <= 1.0


def test_refine_adaptive_rounds_and_selects(toy_data):
    _, ct = _cfgs(toy_data, depth1=1, depth2=1)
    res = tp.refine_adaptive(toy_data, ct, tp.TwoWLRunConfig(epochs=8),
                             n_trials=6, n_batches=3, device="cpu")
    assert res["configs_inspected"] == 6
    assert len(res["round_best_vals"]) == 3
    assert res["best_val"] == pytest.approx(max(res["round_best_vals"]),
                                            abs=1e-4)
    assert 0.0 <= res["test_auc"] <= 1.0
    assert set(res["winner"]) == {"lr", "dp_emb", "dp_1wl0", "dp_1wl1",
                                  "dp_2wl"}


def test_run_twowl_with_refine(tmp_path):
    out = {
        "log_file": str(tmp_path / "logs.json"),
        "state_file": str(tmp_path / "state.jsonl"),
        "roc_dir": str(tmp_path),
        "metrics_file": str(tmp_path / "logs" / "metrics.jsonl"),
        "checkpoint_path": str(tmp_path / "ckpt" / "model"),
    }
    run = tp.TwoWLRunConfig(epochs=2, records_dir=str(tmp_path / "rec"))
    res = tp.run_twowl(run, n_trials=1, device="cpu", verbose=False,
                       refine_trials=3, **out)
    assert (tmp_path / "ckpt" / "model.npz").exists()
    assert 0.0 <= res["test_auc"] <= 1.0
    best = json.loads((tmp_path / "logs.json").read_text())
    assert best == res["best_params"] and set(best) == set(tp.SEARCH_SPACE)
    refined = res["best_val"] > res["trials"][0]["val"]
    lines = (tmp_path / "rec" / "fb-pages-food_auc_record_twowl.txt"
             ).read_text().splitlines()
    assert len(lines) == 1 + refined
    assert all(ln.startswith("AUC:") for ln in lines)
    with pytest.raises(ValueError, match="refine_mode"):
        tp.run_twowl(run, n_trials=1, device="cpu", refine_trials=3,
                     refine_mode="tpe", **out)


def test_cli_parses_refine():
    args = cli.build_parser().parse_args(
        ["twowl", "--epochs", "50", "--trials", "1", "--refine", "8",
         "--refine-mode", "adaptive"])
    assert (args.refine, args.refine_mode, args.epochs, args.trials) == (
        8, "adaptive", 50, 1)
    assert cli.build_parser().parse_args(["twowl"]).refine == 0
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["twowl", "--refine-mode", "tpe"])
    assert set(tp.REFINE_MODES) == {"flat", "halving", "adaptive"}
