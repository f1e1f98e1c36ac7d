"""Parity of the port's collab-scale GCN pipeline
(`linkpred_tpu_torch.pipelines.gcn_scale`) with the JAX package's
single-device `train_collab`, at small size on the CPU.

Inputs come from the same seeds; parameters from the JAX package's
`init_params` are loaded into the port (`params_from_jax`). Tolerances:
host arrays are array-equal; the f32 forward, loss and gradients agree to
rtol 1e-5 (atol 1e-6; sums taken in another order). Training trajectories:
Adam normalises each gradient element, so f32 rounding differences in
embedding rows with gradients near 0 can become lr-size steps, and two
correct runs drift apart with the steps. Over the tiny config's 25 steps
the loss quarters are held to atol 1e-4 and the test AUC to 2e-3; the drift
measured on the CPU at seeds 0-2 was at most 1.4e-6 in loss and 0 in AUC.
In bf16 the two frameworks round at other places (the einsums, the casts of
the gradients), so bf16 runs are held to convergence: loss falls and AUC
beats chance in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from linkpred_tpu.ops import sddmm as jsd
from linkpred_tpu.ops import spmm as jspmm
from linkpred_tpu.parallel import make_mesh
from linkpred_tpu.pipelines import gcn_scale as jgs
from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops import spmm as tspmm
from linkpred_tpu_torch.pipelines import gcn_scale as tgs
from linkpred_tpu_torch.utils import profiling as tprof

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
LOSS_ATOL, AUC_ATOL = 1e-4, 2e-3

# tests/test_parallel.py::TestCollabScaleTraining's tiny config
TINY = dict(nodes=800, edges=3200, steps=25, batch_edges=256, emb_dim=16,
            hidden=32, max_degree=16)


def _np(t):
    return t.detach().float().cpu().numpy()


def _cfg(**kw):
    return tgs.ScaleGCNConfig(**{**TINY, "dtype": "f32", **kw})


def _jax_cfg(cfg):
    return jgs.ScaleGCNConfig(**dataclasses.asdict(cfg))


def _one_device_mesh():
    return make_mesh(n_devices=1, shape=(1, 1))


# ---------------------------------------------------------------------------
# host problem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", ["powerlaw", "community"])
def test_build_problem_equal(graph):
    cfg = _cfg(nodes=3000, edges=12000, seed=3, graph=graph)
    gt, *pt = tgs.build_problem(cfg)
    gj, *pj = jgs.build_problem(_jax_cfg(cfg))
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    for field in ("src", "dst", "indptr", "nbr", "nbr_mask", "degree",
                  "nbr_weight"):
        np.testing.assert_array_equal(getattr(gt, field), getattr(gj, field))
    assert int(gt.degree.max()) <= cfg.max_degree
    # the bucketed layout of the message graph, too
    lt, lj = tspmm.BucketedEll.from_graph(gt), jspmm.BucketedEll.from_graph(gj)
    np.testing.assert_array_equal(lt.inv_perm, lj.inv_perm)
    for bt, bj in zip(lt.buckets, lj.buckets, strict=True):
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)


def test_edges_file_resolves_as_reference(tmp_path):
    path = tmp_path / "edges.txt"
    rng = np.random.default_rng(0)
    e = rng.integers(100, 900, (400, 2))
    np.savetxt(path, e, fmt="%d", delimiter=",", header="u,v", comments="")
    cfg = _cfg(edges_file=str(path))
    ct, ot = tgs.resolve_graph_source(cfg)
    cj, oj = jgs.resolve_graph_source(_jax_cfg(cfg))
    assert (ct.nodes, ct.edges) == (cj.nodes, cj.edges)
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tgs.build_problem(ct, ot)[1:],
                    jgs.build_problem(_jax_cfg(ct), oj)[1:]):
        np.testing.assert_array_equal(a, b)


def test_batch_schedule_draws_as_reference():
    cfg = _cfg()
    _, train_pos, _, _ = tgs.build_problem(cfg)
    got = tgs.batch_schedule(cfg, train_pos)
    # the reference's draws, gcn_scale.py:190-193
    rng = np.random.default_rng(cfg.seed + 1)
    B, S = cfg.batch_edges, cfg.steps
    pos_b = train_pos[rng.integers(0, len(train_pos), (S, B))].astype(np.int32)
    neg_b = rng.integers(0, cfg.nodes, (S, B, 2)).astype(np.int32)
    assert got.shape == (S, 2, 2 * B) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :, :B], pos_b.transpose(0, 2, 1))
    np.testing.assert_array_equal(got[:, :, B:], neg_b.transpose(0, 2, 1))


# ---------------------------------------------------------------------------
# model: forward, loss and gradients from shared parameters
# ---------------------------------------------------------------------------


def _jax_loss(cfg, ops_j, pos, neg):
    """The reference's `embed_all` and `loss_fn` (gcn_scale.py:199-215) at
    f32, on its own kernels."""
    def embed_all(p):
        x = p["emb"]
        a1 = jspmm.spmm_bucketed_sym(x, cfg.nodes, ops_j)
        h = jax.nn.relu(a1 @ p["w1"] + x @ p["w1s"])
        a2 = jspmm.spmm_bucketed_sym(h, cfg.nodes, ops_j)
        return a2 @ p["w2"] + h @ p["w2s"]

    def loss(p):
        h = embed_all(p)
        logits = jnp.concatenate([jsd.sddmm_coo(pos[:, 0], pos[:, 1], h),
                                  jsd.sddmm_coo(neg[:, 0], neg[:, 1], h)])
        y = jnp.concatenate([jnp.ones(len(pos)), jnp.zeros(len(neg))])
        return optax.sigmoid_binary_cross_entropy(logits, y).mean()

    return embed_all, loss


@pytest.mark.parametrize("seed", [0, 4])
def test_params_from_jax_forward_loss_and_grads(seed):
    cfg = _cfg(seed=seed)
    g, train_pos, _, _ = tgs.build_problem(cfg)
    pj = jgs.init_params(jax.random.PRNGKey(seed), _jax_cfg(cfg))
    params = tgs.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    ops_j = jspmm.BucketedEll.from_graph(g).operands()
    ops = tspmm.BucketedEll.from_graph(g).operands("cpu")
    batch = tgs.batch_schedule(cfg, train_pos)[0]  # [2, 2B]
    B = cfg.batch_edges
    pos, neg = batch[:, :B].T, batch[:, B:].T

    embed_j, loss_j = _jax_loss(cfg, ops_j, jnp.asarray(pos), jnp.asarray(neg))
    np.testing.assert_allclose(_np(tgs.embed_all(params, ops, cfg)),
                               np.asarray(embed_j(pj)), rtol=RTOL, atol=ATOL)
    lj, gj = jax.value_and_grad(loss_j)(pj)
    loss = tgs.loss_fn(params, torch.from_numpy(batch), ops, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=RTOL)
    for k in params:
        np.testing.assert_allclose(_np(params[k].grad), np.asarray(gj[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_init_params_shapes_and_scale():
    cfg = _cfg()
    p = tgs.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pj = jgs.init_params(jax.random.PRNGKey(0), _jax_cfg(cfg))
    for k in pj:
        assert tuple(p[k].shape) == pj[k].shape and p[k].requires_grad
        assert p[k].dtype == torch.float32
    assert abs(float(p["emb"].std()) - 0.1) < 0.01
    lim = float(np.sqrt(6.0 / (cfg.emb_dim + cfg.hidden)))
    assert float(p["w1"].abs().max()) <= lim


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 2])
def test_tiny_f32_trajectory_matches_jax(seed):
    cfg = _cfg(seed=seed)
    ref = jgs.train_collab(_jax_cfg(cfg), mesh=_one_device_mesh(),
                           verbose=False)
    problem = tgs.build_problem(cfg)
    ops = tspmm.BucketedEll.from_graph(problem[0]).operands("cpu")
    pj = jgs.init_params(jax.random.PRNGKey(cfg.seed), _jax_cfg(cfg))
    params = tgs.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    got = tgs.train_and_score(cfg, problem, ops, params, "cpu")
    assert set(got) | {"build_seconds"} == set(ref)
    for k in ("nodes", "directed_edges", "shards", "steps", "loss_decreased"):
        assert got[k] == ref[k], k
    for k in ("loss_first_quarter", "loss_last_quarter"):
        np.testing.assert_allclose(got[k], ref[k], atol=LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(got["test_auc"], ref["test_auc"],
                               atol=AUC_ATOL)


def test_tiny_bf16_converges_in_both():
    cfg = _cfg(dtype="bf16")
    ref = jgs.train_collab(_jax_cfg(cfg), mesh=_one_device_mesh(),
                           verbose=False)
    got = tgs.train_collab(cfg, device="cpu", verbose=False)
    for out in (ref, got):
        assert out["loss_decreased"], out
        assert out["test_auc"] > 0.55, out
    assert set(got) == set(ref)


def test_train_collab_runs_the_kernel_wrappers():
    """On the CPU the wrappers take their plain versions, and count no
    launch: `LAUNCHES` counts kernels on the card only."""
    before = dict(hk.LAUNCHES)
    out = tgs.train_collab(_cfg(steps=4), device="cpu", verbose=False)
    assert np.isfinite(out["loss_first_quarter"])
    assert hk.LAUNCHES == before


def test_plain_versions_give_the_same_step():
    """`train_steps` and `test_logits` with the plain aggregation and
    scoring give the same numbers as the defaults (on the CPU both are the
    plain versions; on the card tests/test_torch_cuda.py holds the kernels
    to them)."""
    cfg = _cfg(steps=3)
    g, train_pos, test_pos, _ = tgs.build_problem(cfg)
    ops = tspmm.BucketedEll.from_graph(g).operands("cpu")
    batches = torch.from_numpy(tgs.batch_schedule(cfg, train_pos))
    pairs = torch.from_numpy(np.ascontiguousarray(test_pos.T.astype(np.int32)))
    runs = []
    for agg, score in ((tspmm.spmm_bucketed_sym, tgs.sddmm_coo),
                       (tspmm.spmm_bucketed_sym_reference,
                        lambda s, d, h: hk.sddmm_reference(s, d, h, h).to(
                            h.dtype))):
        p = tgs.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        losses = tgs.train_steps(p, tgs.adam(p, cfg.learning_rate), batches,
                                 ops, cfg, agg, score)
        runs.append((losses, tgs.test_logits(p, pairs, ops, cfg, agg, score)))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(runs[0][1], runs[1][1], rtol=RTOL, atol=ATOL)


def test_halo_and_several_cards_raise(monkeypatch):
    """Without a mesh the halo path, which splits the graph over ranks,
    raises; so does a process that sees several cards with no process
    group, naming the torchrun command (it must not quietly use one card)."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node N"):
        tgs.train_collab(_cfg(aggregation="halo"), device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node N"):
        tgs.train_collab(_cfg(), device="cuda")


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    """`distributed.initialize` under torchrun's environment: NCCL with
    more ranks on the host than visible cards raises before it joins, and
    neither remaps the ranks nor changes the backend."""
    from linkpred_tpu_torch.parallel import distributed

    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: pytest.fail(
        "set_device called before the check"))
    with pytest.raises(RuntimeError, match="2 ranks on this host and 1"):
        distributed.initialize(backend="nccl", device_type="cuda")
    assert not torch.distributed.is_initialized()


def test_throughput_counter_matches_reference(monkeypatch):
    """`ThroughputCounter` spans, rate and report as the reference's, on a
    clock that both read from the same `time.perf_counter`."""
    import time

    from linkpred_tpu.utils import profiling as jprof

    ticks = iter([0.0, 0.5, 1.0, 1.25] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    counters = []
    for mod in (tprof, jprof):
        c = mod.ThroughputCounter(unit="agg-edges")
        assert c.rate == 0.0
        for items in (100, 50):
            with c.span(items):
                pass
        counters.append(c)
    ct, cj = counters
    assert (ct.items, ct.seconds, ct.rate) == (cj.items, cj.seconds, cj.rate)
    assert ct.rate == 150 / 0.75
    assert ct.report() == cj.report()
