"""The multi-process proof of `tests/test_multihost.py`, for the port: real
`torch.distributed` ranks (four gloo processes on the CPU, rank bodies in
`tests/torch_ranks.py`) in a ("host", "data", "edge") mesh of (2, 1, 2)
from `parallel.distributed.hybrid_mesh`, training TwoWL with the ei2 slots
split over ``edge`` and SEAL with the subgraph batch split over the whole
mesh.

As in the reference's proof: the SGD run's parameters are within 2e-4 of
the one-process run's (here the port's own, in this process, on the whole
split and batch with the same batches and dropout masks); a whole-job
crash at step K (every rank exits with 17 after the checkpoint) and a
resume give parameters within 2e-4 of the uninterrupted Adam run's. The
ranks hold one value of every parameter (largest difference 0).
"""

import numpy as np
import pytest
import torch

import torch_ranks
from linkpred_tpu_torch.data.twowl import build_twowl_data
from linkpred_tpu_torch.models import seal
from linkpred_tpu_torch.models import twowl as m
from linkpred_tpu_torch.parallel import distributed, multihost

torch.set_num_threads(1)

TOL = 2e-4
STEPS, INTERRUPT = 4, 2


def _data():
    """`benchmarks/multihost_worker.py`'s toy problems: TwoWL on a chain of
    32 nodes plus 90 random pairs (ei2 slots a multiple of 2), SEAL on 16
    random subgraphs of 16 nodes; the batches and dropout masks of every
    step; parameters from the port's seeded init."""
    rng = np.random.default_rng(7)
    n = 32
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    extra = np.stack([rng.integers(0, n, 90), rng.integers(0, n, 90)], 1)
    pairs = np.concatenate([chain, extra])
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    d = build_twowl_data(pairs, n, rng=rng, ei2_bucket=256)
    cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=16,
                        channels_2wl=8, depth1=2, depth2=2,
                        learning_rate=0.01, agg_1wl="ell")
    n_pos, n_neg = d.train.num_msg // 2, len(d.train.pred) // 2
    batch = min(8, n_pos, n_neg)
    batches = []
    for step in range(STEPS):
        srng = np.random.default_rng(1000 + step)
        batches.append((srng.permutation(n_pos)[:batch],
                        srng.permutation(n_neg)[:batch]))
    twowl_params = m.tree_map(lambda t: t.detach().numpy(), m.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))

    B, K, F = 16, 16, 6
    srng = np.random.default_rng(5)
    adj = (srng.random((B, K, K)) < 0.2).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.transpose(0, 2, 1)
    a_tilde = adj + np.eye(K, dtype=np.float32)[None]
    d_inv = (1.0 / a_tilde.sum(axis=2)).astype(np.float32)
    x = srng.standard_normal((B, K, F)).astype(np.float32)
    seal_batch = (d_inv, a_tilde, x, np.ones((B, K), dtype=bool),
                  srng.integers(0, 2, size=B).astype(np.int64))
    sp = seal.init_params(torch.Generator().manual_seed(1), F, 8, "cpu")
    seal_params = seal.DGCNNParams(tuple(t.detach().numpy() for t in sp.gw),
                                   *(t.detach().numpy() for t in sp[1:]))
    keep = [torch.rand((B, seal.DENSE_NODES),
                       generator=torch.Generator().manual_seed(77 + s)
                       ).numpy() < 0.5 for s in range(STEPS)]
    return dict(split=d.train, cfg=cfg, num_nodes=n, batches=batches,
                twowl_params=twowl_params, seal_batch=seal_batch,
                seal_params=seal_params, seal_keep=keep)


def _one_process(data, opt):
    """The same training in this process on the whole split and batch."""
    make = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}[opt]
    arrays = m.SplitArrays.from_split(data["split"], "cpu")
    params = m.params_from_jax(data["twowl_params"], "cpu")
    o = make(m.tree_leaves(params), lr=data["cfg"].learning_rate)
    losses, seal_losses = [], []
    for step, (pos, neg) in enumerate(data["batches"]):
        losses.append(float(m.train_step(
            params, o, torch.Generator().manual_seed(1000 + step),
            torch.as_tensor(pos), torch.as_tensor(neg), arrays, data["cfg"],
            data["num_nodes"])[0]))
    sp = seal.params_from_jax(data["seal_params"], "cpu")
    so = make(seal.leaves(sp), lr=1e-3)
    batch = [torch.as_tensor(a) for a in data["seal_batch"]]
    for step in range(STEPS):
        so.zero_grad()
        loss = seal.loss_fn(sp, *batch[:4], batch[4], 8, dropout_rate=0.5,
                            keep=torch.as_tensor(data["seal_keep"][step]))
        loss.backward()
        so.step()
        seal_losses.append(float(loss.detach()))
    return ([p.detach().numpy() for p in m.tree_leaves(params)],
            [p.detach().numpy() for p in seal.leaves(sp)],
            losses, seal_losses)


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def proof(tmp_path_factory):
    data = _data()
    out = str(tmp_path_factory.mktemp("multihost"))
    runs = multihost.launch(torch_ranks.multihost_jobs, 4, out,
                            args=(data, STEPS, out))
    crash = multihost.launch(torch_ranks.multihost_job, 4, out,
                             args=(data, STEPS, "adam", out, "crash",
                                   INTERRUPT), expect_rc=17)
    resumed = multihost.launch(torch_ranks.multihost_job, 4, out,
                               args=(data, STEPS, "adam", out, "resumed",
                                     INTERRUPT, True))
    return data, runs, crash, resumed


def test_multihost_sgd_matches_one_process(proof):
    data, runs, _, _ = proof
    twowl_ref, seal_ref, _, _ = _one_process(data, "sgd")
    sgd = runs[0][0]
    assert sgd["processes"] == 4 and sgd["tag"] == "sgd"
    assert _max_diff(sgd["twowl_params"], twowl_ref) < TOL
    assert _max_diff(sgd["seal_params"], seal_ref) < TOL
    assert [r[0]["spread"] for r in runs] == [0.0] * 4


def test_multihost_adam_tracks_one_process(proof):
    """Adam turns the all-reduce's rounding in gradient components near 0
    into lr-sized steps, so, as the reference's proof, the Adam run is held
    by its loss trajectory, TwoWL's and SEAL's, to 50x the tolerance."""
    data, runs, _, _ = proof
    adam = runs[0][1]
    _, _, losses, seal_losses = _one_process(data, "adam")
    assert len(adam["twowl_losses"]) == len(adam["seal_losses"]) == STEPS
    np.testing.assert_allclose(adam["twowl_losses"], losses, atol=50 * TOL)
    np.testing.assert_allclose(adam["seal_losses"], seal_losses,
                               atol=50 * TOL)


def test_multihost_crash_and_resume(proof):
    _, runs, crash, resumed = proof
    assert crash == [None] * 4  # every rank exited with 17 at the checkpoint
    whole, res = runs[0][1], resumed[0]
    assert len(res["twowl_losses"]) == STEPS - INTERRUPT
    np.testing.assert_allclose(res["twowl_losses"],
                               whole["twowl_losses"][INTERRUPT:], atol=TOL)
    assert _max_diff(res["twowl_params"], whole["twowl_params"]) < TOL
    assert res["spread"] == 0.0


def test_multihost_ranks_load_no_jax(proof):
    _, runs, _, resumed = proof
    assert all(r[0]["jax_modules"] == [] for r in runs)
    assert all(r["jax_modules"] == [] for r in resumed)


def test_initialize_without_a_job_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()


def _torchrun_env(monkeypatch, port):
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)


def test_initialize_without_a_card_raises(monkeypatch):
    """Under torchrun's environment with no card visible and no device
    type named, `initialize` raises instead of joining a gloo job on the
    CPU."""
    _torchrun_env(monkeypatch, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        distributed.initialize()
    assert not torch.distributed.is_initialized()


def test_initialize_joins_a_cpu_job_by_name(monkeypatch):
    """A CPU job that names `device_type="cpu"` still joins, on gloo."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    _torchrun_env(monkeypatch, port)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        assert distributed.initialize(device_type="cpu", timeout_s=60.0)
        assert torch.distributed.get_backend() == "gloo"
        assert torch.distributed.get_world_size() == 1
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
