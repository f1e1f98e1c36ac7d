"""Parity of the port's multi-device stack (`linkpred_tpu_torch.parallel`:
`mesh`, `spmm_shard`, `dp`, and the node-sharded `train_collab`) with the
JAX package's `linkpred_tpu.parallel`, on the CPU.

The port runs as 2 and 4 real `torch.distributed` ranks (gloo, spawned by
`parallel.multihost.launch`; the rank bodies are in `tests/torch_ranks.py`,
which imports no JAX); the JAX side runs in this process on a mesh of the
same size taken from the 8 virtual CPU devices. Inputs are made from numpy
seeds; parameters are the JAX package's, loaded into the port.

Tolerances: host layouts are array-equal; the sharded SpMMs, their
gradients and one SGD step of the sharded TwoWL and SEAL steps agree to
rtol 1e-5 (f32 sums in another order; the reference's own
sharded-equals-replicated check holds 1e-5). Trial-sharded val AUCs to
1e-5. `train_collab` trajectories at `tests/test_torch_gcn.py`'s
tolerances: loss quarters to atol 1e-4, test AUC to 2e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ranks
from linkpred_tpu.data.graph import Graph as JGraph
from linkpred_tpu.parallel import make_mesh as jmake_mesh
from linkpred_tpu.parallel import spmm_shard as jss
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.parallel import multihost
from linkpred_tpu_torch.parallel import spmm_shard as tss

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
LOSS_ATOL, AUC_ATOL = 1e-4, 2e-3


def _sym_norm(g):
    d = np.asarray(g.degree, np.float64) + 1.0
    inv = (1.0 / np.sqrt(d)).astype(np.float32)
    w = inv[:, None] * inv[np.asarray(g.nbr)]
    return dataclasses.replace(g, nbr_weight=np.ascontiguousarray(w))


def _random_graph(cls, n, e, seed):
    rng = np.random.default_rng(seed)
    pairs = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return _sym_norm(cls.from_undirected_edges(pairs[:, 0], pairs[:, 1],
                                               num_nodes=n))


def _hub_graph(cls, n=77, cap=6, seed=0):
    """tests/test_parallel.py's capped-hub graph (77 nodes, not 80: the
    row count then does not divide by the shards): 4 hubs over the cap."""
    rng = np.random.default_rng(seed)
    hubs = np.arange(4)
    u = np.concatenate([np.repeat(hubs, n - 1), rng.integers(0, n, 120)])
    v = np.concatenate([np.tile(np.arange(1, n), 4) % n,
                        rng.integers(0, n, 120)])
    keep = u != v
    g = cls.from_undirected_edges(u[keep], v[keep], num_nodes=n)
    return _sym_norm(g.with_degree_cap(cap, rng=np.random.default_rng(7),
                                       symmetric=True))


def _jmesh(world, shape=None):
    return jmake_mesh(n_devices=world, shape=shape or (1, world))


# ---------------------------------------------------------------------------
# host layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,e,shards", [(77, 300, 2), (77, 300, 4),
                                        (61, 250, 3), (800, 3200, 8)])
def test_build_node_sharded_buckets_equal(n, e, shards):
    got = tss.build_node_sharded_buckets(_random_graph(Graph, n, e, n),
                                         shards)
    ref = jss.build_node_sharded_buckets(_random_graph(JGraph, n, e, n),
                                         shards)
    assert got[0] == ref[0] and got[1] == ref[1]
    assert len(got[2]) == len(ref[2])
    for a, b in zip(got[2], ref[2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_build_node_sharded_buckets_equal_capped_hubs():
    got = tss.build_node_sharded_buckets(_hub_graph(Graph), 2)
    ref = jss.build_node_sharded_buckets(_hub_graph(JGraph), 2)
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_array_equal(a, b)


def test_pad_edges_for_mesh_equal():
    rng = np.random.default_rng(0)
    arrs = [rng.integers(0, 9, 13).astype(np.int32),
            rng.random(13).astype(np.float32)]
    got, mask = tss.pad_edges_for_mesh(arrs, 4)
    ref, rmask = jss.pad_edges_for_mesh([jnp.asarray(a) for a in arrs], 4)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(mask, np.asarray(rmask))
    tgot, tmask = tss.pad_edges_for_mesh([torch.as_tensor(a) for a in arrs], 4)
    for a, b in zip(tgot, got):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tmask.numpy(), mask)


# ---------------------------------------------------------------------------
# the sharded SpMMs, forward and gradient, against the JAX package's
# ---------------------------------------------------------------------------


def _ops_inputs():
    rng = np.random.default_rng(11)
    n = 77
    x = rng.standard_normal((n, 16)).astype(np.float32)
    t = rng.standard_normal((n, 16)).astype(np.float32)
    src = rng.integers(0, n, 200).astype(np.int32)
    dst = rng.integers(0, n, 200).astype(np.int32)
    w = rng.random(200).astype(np.float32)
    return x, t, src, dst, w


@pytest.fixture(scope="module", params=[2, 4])
def port_runs(request, tmp_path_factory):
    """Every port-side case of this file over `world` ranks, in one job
    (`torch_ranks.parallel_all`): each rank's results by case."""
    world = request.param
    cases = {
        "ops": (_random_graph(Graph, 77, 300, 1), _hub_graph(Graph), *
                _ops_inputs()[:2], _ops_inputs()[2:]),
        "twowl": _twowl_case()[0],
        "seal": _seal_case()[0],
        "seal_divide": (_seal_batch(5),),
        "trials": _trial_case()[0],
        "collab": _collab_case(world)[0],
    }
    if world == 2:
        cases["dryrun"] = ()
    return world, multihost.launch(torch_ranks.parallel_all, world,
                                   str(tmp_path_factory.mktemp("job")),
                                   args=(cases,))


@pytest.fixture(scope="module")
def sharded_ops(port_runs):
    world, out = port_runs
    return world, out[0]["ops"], None


# The JAX package's results are one function whatever its mesh size: each
# is computed once, on a 2-device mesh, and held against the port's runs
# on 2 and on 4 ranks (a JAX compile costs seconds; a rank launch less).


@functools.cache
def _jax_ops():
    x, t, src, dst, w = _ops_inputs()
    mesh = _jmesh(2)
    out = {}
    g = _random_graph(JGraph, 77, 300, 1)
    rows, _, stacked = jss.build_node_sharded_buckets(g, 2)
    sj = tuple(jnp.asarray(a) for a in stacked)
    # jitted: op by op, shard_map costs seconds a call on the CPU
    out["node_sharded"] = np.asarray(jax.jit(
        lambda xx: jss.spmm_node_sharded(mesh, xx, 77, rows, *sj))(
            jnp.asarray(x)))
    for name, graph in (("sym", g), ("sym_capped", _hub_graph(JGraph))):
        n = graph.num_nodes
        rows, _, stacked = jss.build_node_sharded_buckets(graph, 2)
        sj = tuple(jnp.asarray(a) for a in stacked)

        def loss(xx):
            o = jss.spmm_node_sharded_sym(mesh, xx, n, rows, sj)
            return jnp.sum(o * jnp.asarray(t[:n])), o

        (_, fwd), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jnp.asarray(x[:n]))
        out[name], out[name + "_grad"] = np.asarray(fwd), np.asarray(grad)
    (sp, dp_, wp), mask = jss.pad_edges_for_mesh(
        [jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)], 2)

    def loss_e(xx):
        o = jss.spmm_edge_partitioned(mesh, sp, dp_, xx, 77, edge_weight=wp,
                                      mask=mask)
        return jnp.sum(o * jnp.asarray(t)), o

    (_, fwd), grad = jax.jit(jax.value_and_grad(loss_e, has_aux=True))(
        jnp.asarray(x))
    out["edge"], out["edge_grad"] = np.asarray(fwd), np.asarray(grad)
    return out


def test_make_mesh_default_shape(sharded_ops):
    world, out, _ = sharded_ops
    assert out["mesh_default"] == (("data", "edge"), (world // 2, 2))


def test_node_sharded_matches_jax(sharded_ops):
    _, out, _ = sharded_ops
    np.testing.assert_allclose(out["node_sharded"], _jax_ops()["node_sharded"],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_pipelined_matches_jax(sharded_ops, chunks):
    """Against the JAX package's node-sharded product, which its own
    pipelined form equals for every chunk count
    (`tests/test_parallel.py::TestPipelinedOverlapSpMM`)."""
    _, out, _ = sharded_ops
    np.testing.assert_allclose(out[f"pipelined_{chunks}"],
                               _jax_ops()["node_sharded"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["sym", "sym_capped"])
def test_node_sharded_sym_grad_matches_jax(sharded_ops, name):
    _, out, _ = sharded_ops
    ref = _jax_ops()
    np.testing.assert_allclose(out[name], ref[name], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[name + "_grad"], ref[name + "_grad"],
                               rtol=RTOL, atol=ATOL)


def test_edge_partitioned_matches_jax(sharded_ops):
    _, out, _ = sharded_ops
    ref = _jax_ops()
    np.testing.assert_allclose(out["edge"], ref["edge"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out["edge_grad"], ref["edge_grad"], rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the training steps: TwoWL edge-sharded, SEAL data-parallel, trial-sharded
# ---------------------------------------------------------------------------


def _twowl_data(n, seed, ei2_bucket, pairs_count=140):
    from linkpred_tpu.data.twowl import build_twowl_data as jbuild
    from linkpred_tpu_torch.data.twowl import build_twowl_data as tbuild

    rng = np.random.default_rng(seed)
    pairs = np.stack([rng.integers(0, n, pairs_count),
                      rng.integers(0, n, pairs_count)], axis=1)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return (tbuild(pairs, n, rng=np.random.default_rng(seed + 1),
                   ei2_bucket=ei2_bucket),
            jbuild(pairs, n, rng=np.random.default_rng(seed + 1),
                   ei2_bucket=ei2_bucket))


@functools.cache
def _twowl_case():
    """The rank body's arguments (a split whose ei2 slots are a multiple of
    2 and 4, the config, the JAX parameters, the batch) and the JAX
    package's edge-sharded SGD step on a (4, 2) mesh
    (`tests/test_parallel.py`'s check): its leaves and loss."""
    from linkpred_tpu.models import twowl as jm
    from linkpred_tpu.parallel import dp as jdp
    from linkpred_tpu_torch.models import twowl as tm

    d, dj = _twowl_data(32, 5, 64)
    kw = dict(max_degree=d.max_degree, channels_1wl=16, channels_2wl=8,
              depth1=2, depth2=2, learning_rate=0.01, dp_emb=0.0,
              dp_1wl0=0.0, dp_1wl1=0.0, dp_2wl=0.0)
    cfg_j = jm.TwoWLConfig(**kw)
    cfg_t = tm.TwoWLConfig(**kw, agg_1wl="ell")
    pj = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    P = min(6, d.train.num_msg // 2, len(d.train.pred) // 2)
    pos = np.arange(P)
    neg = np.arange(P)[::-1].copy()
    opt = optax.sgd(cfg_j.learning_rate)
    mesh = _jmesh(8, (4, 2))
    placed = jdp.shard_twowl_split(mesh, jm.SplitArrays.from_split(dj.train))
    ref_p, _, ref_loss, _, _ = jm.train_step(
        jdp.replicate(mesh, pj), jdp.replicate(mesh, opt.init(pj)),
        jax.random.PRNGKey(3), jnp.asarray(pos, jnp.int32),
        jnp.asarray(neg, jnp.int32), placed, cfg_j, opt, d.num_nodes)
    args = (d.train, cfg_t, jax.tree_util.tree_map(np.asarray, pj), pos, neg,
            d.num_nodes)
    return args, ([np.asarray(a) for a in jax.tree_util.tree_leaves(ref_p)],
                  float(ref_loss))


def test_twowl_edge_sharded_sgd_step_matches_jax(port_runs):
    """One SGD step (no dropout) on K1 and K3's plain versions from the JAX
    parameters, the ei2 slots split over the ranks, and the same step on
    the whole split: both equal the JAX package's edge-sharded step."""
    from linkpred_tpu_torch.models import twowl as tm

    _, out = port_runs
    args, (ref_leaves, ref_loss) = _twowl_case()
    first = out[0]["twowl"]
    for name in ("sharded", "whole"):
        leaves, loss, _ = first[name]
        np.testing.assert_allclose(loss, ref_loss, rtol=RTOL)
        for a, b in zip(leaves, ref_leaves):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        # the ranks hold one value of every parameter
        assert first[name + "_spread"] == 0.0
    # each rank aggregated its own slice of the slots
    whole = tm.SplitArrays.from_split(args[0], "cpu").e1_cops[0].k3[2]
    slots = [r["twowl"]["slots_here"] for r in out]
    assert sum(slots) >= whole.shape[0] and max(slots) < whole.shape[0]


def _seal_batch(B, k=16, f=6, seed=5):
    rng = np.random.default_rng(seed)
    adj = (rng.random((B, k, k)) < 0.2).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.transpose(0, 2, 1)
    a_tilde = adj + np.eye(k, dtype=np.float32)[None]
    d_inv = (1.0 / a_tilde.sum(axis=2)).astype(np.float32)
    x = rng.standard_normal((B, k, f)).astype(np.float32)
    node_mask = np.ones((B, k), dtype=bool)
    y = rng.integers(0, 2, size=B).astype(np.int64)
    return d_inv, a_tilde, x, node_mask, y


@functools.cache
def _seal_case():
    """The rank body's arguments (a batch of 8 subgraphs, the JAX
    parameters, lr, the whole batch's dropout mask) and the JAX package's
    SGD step on the whole batch without dropout: its leaves."""
    from linkpred_tpu.models import seal as js
    from linkpred_tpu_torch.models import seal as ts

    batch, lr = _seal_batch(8), 0.05
    pj = js.init_params(jax.random.PRNGKey(1), 6, 8)
    opt = optax.sgd(lr)
    ref_p, _, _ = js.train_step(pj, opt.init(pj), *(jnp.asarray(a) for a in
                                                    batch[:4]),
                                jnp.asarray(batch[4], jnp.int32),
                                jax.random.PRNGKey(2), 8, 0.0, opt)
    keep = np.random.default_rng(3).random((8, ts.DENSE_NODES)) < 0.5
    # the port's own NamedTuple: a rank that unpickled the JAX package's
    # would import it, and JAX with it
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(pj)]
    pnp = ts.DGCNNParams(tuple(leaves[:4]), *leaves[4:])
    args = (pnp, batch, lr, keep)
    return args, [np.asarray(a) for a in jax.tree_util.tree_leaves(ref_p)]


def test_seal_data_parallel_step_matches(port_runs):
    """One SGD step with the batch split over every rank: in eval mode
    against the JAX package's step on the whole batch, and with the whole
    batch's dropout mask given against the port's one-process step."""
    from linkpred_tpu_torch.models import seal as ts

    _, out = port_runs
    (pnp, batch, lr, keep), ref_leaves = _seal_case()
    for r in out:
        for a, b in zip(r["seal"]["eval"], ref_leaves):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    p = ts.params_from_jax(pnp, "cpu")
    sgd = torch.optim.SGD(ts.leaves(p), lr=lr)
    ts.loss_fn(p, *(torch.as_tensor(a) for a in batch[:4]),
               torch.as_tensor(batch[4]), 8, dropout_rate=0.5,
               keep=torch.as_tensor(keep)).backward()
    sgd.step()
    for a, b in zip(out[0]["seal"]["masks"], ts.leaves(p)):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_seal_batch_must_divide(port_runs):
    world, out = port_runs
    assert out[0]["seal_divide"] == f"5 items do not divide into {world} shards"


@functools.cache
def _trial_case():
    """The rank body's arguments (eight trials of a toy split, the JAX
    parameters, the batches of 3 epochs) and the JAX package's unsplit
    `train_scan_trials` from them: losses and val AUCs [E, T], best val
    AUCs [T]."""
    from linkpred_tpu.data.twowl import build_twowl_data as jbuild
    from linkpred_tpu.models import twowl as jm
    from linkpred_tpu_torch.data.twowl import build_twowl_data as tbuild
    from linkpred_tpu_torch.models import twowl as tm

    rng = np.random.default_rng(7)
    n = 30
    pairs = np.stack([rng.integers(0, n, 120), rng.integers(0, n, 120)], 1)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    d = tbuild(pairs, n, rng=np.random.default_rng(8))
    dj = jbuild(pairs, n, rng=np.random.default_rng(8))
    kw = dict(max_degree=d.max_degree, channels_1wl=8, channels_2wl=8,
              depth1=1, depth2=1)
    cfg_j, cfg_t = jm.TwoWLConfig(**kw), tm.TwoWLConfig(**kw, agg_1wl="ell")
    T, E = 8, 3
    pj = jm.init_params_trials(jax.random.PRNGKey(0), cfg_j, T)
    npp, nnp = d.train.num_msg // 2, len(d.train.pred) // 2
    P = min(len(d.val.y), npp, nnp)
    pos = np.stack([rng.permutation(npp)[:P] for _ in range(E)])
    neg = np.stack([rng.permutation(nnp)[:P] for _ in range(E)])
    opt = optax.adam(1.0)
    out = jm.train_scan_trials(
        pj, opt.init(pj), jax.random.PRNGKey(1), jnp.asarray(pos, jnp.int32),
        jnp.asarray(neg, jnp.int32), jm.SplitArrays.from_split(dj.train),
        jm.SplitArrays.from_split(dj.val), jnp.asarray(dj.val.y),
        jnp.asarray(dj.node_deg), cfg_j, opt, jnp.full((T,), 1e-3),
        n, E, jm.TrialRates(*[jnp.zeros((T,))] * 4))
    args = (d.train, d.val, cfg_t, jax.tree_util.tree_map(np.asarray, pj),
            T, pos, neg, d.val.y, d.node_deg, n)
    return args, [np.asarray(a) for a in out[4]], np.asarray(out[3])


def test_trial_sharded_sweep_matches_jax(port_runs):
    """`train_loop_trials` with the trials split over ``data`` against the
    JAX package's unsplit `train_scan_trials`, from its parameters (no
    dropout; lr 1e-3 as `tests/test_torch_trials.py`): every trial's val
    AUC per epoch and best val AUC to 1e-5, its losses to rtol 1e-3."""
    world, out = port_runs
    args, (loss_j, auc_j), best_j = _trial_case()
    T = args[4]
    assert [r["trials"]["trials_here"] for r in out] == [T // world] * world
    got = out[0]["trials"]
    np.testing.assert_allclose(got["aucs"], auc_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["best"], best_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["losses"], loss_j, rtol=1e-3)


# ---------------------------------------------------------------------------
# train_collab: node-sharded and halo, from the JAX package's parameters
# ---------------------------------------------------------------------------


TINY = dict(nodes=800, edges=3200, steps=25, batch_edges=256, emb_dim=16,
            hidden=32, max_degree=16, dtype="f32")


@functools.cache
def _collab_case(world):
    """The rank body's arguments for `world` ranks (`tests/test_parallel.py`'s
    tiny configs: node-sharded on the power-law graph, halo on the
    community graph, drawn both ways; their host builds; the JAX
    parameters) and the JAX package's `train_collab(mesh=...)` that each
    port run is held to, over as many devices.

    The port's default halo run draws its pairs in the problem's ids and
    renames them, its embedding rows with them: it is the one-card run, so
    its reference is the JAX node-sharded run of its graph. With
    `reference_draw` it draws as the JAX halo run does, which is then its
    reference (ROADMAP section 3, F8)."""
    from linkpred_tpu.pipelines import gcn_scale as jgs
    from linkpred_tpu_torch.pipelines import gcn_scale as tgs

    halo = tgs.ScaleGCNConfig(**TINY, aggregation="halo", graph="community")
    cfgs = [tgs.ScaleGCNConfig(**TINY), halo, halo]
    draws = [False, False, True]
    pj = jgs.init_params(jax.random.PRNGKey(0), jgs.ScaleGCNConfig(**TINY))
    refs = [jgs.train_collab(jgs.ScaleGCNConfig(**dict(
                dataclasses.asdict(c), aggregation=(
                    c.aggregation if d else "node_sharded"))),
                             mesh=_jmesh(world), verbose=False)
            for c, d in zip(cfgs, draws)]
    builts = [tgs.build_sharded(c, world) for c in cfgs[:2]]
    args = (cfgs, builts + builts[1:], jax.tree_util.tree_map(np.asarray, pj),
            draws)
    return args, refs


def test_train_collab_sharded_matches_jax(port_runs):
    """Node-sharded and halo `train_collab` over the ranks, from the same
    parameters as the JAX package's run over as many devices: node-sharded
    and the default halo run against its node-sharded run, the halo run
    with the reference's draw against its halo run. Loss quarters to 1e-4,
    test AUC to 2e-3, one value of every weight on all ranks."""
    world, out = port_runs
    (cfgs, _, _, draws), refs = _collab_case(world)
    for cfg, draw, ref, (res, losses) in zip(cfgs, draws, refs,
                                             out[0]["collab"]):
        what = f"{cfg.aggregation} (reference draw {draw})"
        assert res["shards"] == ref["shards"] == world
        assert res["aggregation"] == cfg.aggregation
        for k in ("nodes", "directed_edges", "steps", "loss_decreased"):
            assert res[k] == ref[k], (what, k)
        for k in ("loss_first_quarter", "loss_last_quarter"):
            np.testing.assert_allclose(res[k], ref[k], atol=LOSS_ATOL,
                                       err_msg=f"{what} {k}")
        np.testing.assert_allclose(res["test_auc"], ref["test_auc"],
                                   atol=AUC_ATOL, err_msg=what)
        assert res["spread"] == 0.0 and len(losses) == cfg.steps
        if cfg.aggregation == "halo":
            assert res["ghost_capacity"] >= 1 and res["edge_cut"] > 0


def test_ranks_load_no_jax(port_runs):
    _, out = port_runs
    assert [r["jax_modules"] for r in out] == [[]] * len(out)


def test_dryrun_multichip(port_runs):
    world, out = port_runs
    if world != 2:
        assert "dryrun" not in out[0]
        return
    lines = out[0]["dryrun"]
    assert out[1]["dryrun"] == []  # rank 0 prints
    assert lines[-1] == "dryrun_multichip OK", lines
    assert lines[-2] == ("distributed sgns step: tables feature-sharded "
                         "2-way, corpus 2-sharded"), lines
    assert not any("not ported" in ln for ln in lines), lines
