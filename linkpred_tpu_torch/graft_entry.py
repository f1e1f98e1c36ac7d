"""The entry points of the port — the counterpart of `entry()` and
`dryrun_multichip()` in the repository's `__graft_entry__.py`.

`entry()` returns a forward step of the flagship model (TwoWL's LocalWLNet,
the best-AUC family) with example arguments, on the card by default:

    from linkpred_tpu_torch.graft_entry import entry
    fn, args = entry()              # on the card; entry("cpu") on the host
    scores = fn(*args)              # [pairs] sigmoid scores of the test split

`dryrun_multichip(n)` runs one step of each mesh-parallel path on tiny
shapes; every rank of an initialized world of `n` ranks calls it (under
`torchrun`, or `parallel.multihost.launch`).
"""

from __future__ import annotations

import numpy as np
import torch

from linkpred_tpu_torch.data.twowl import build_twowl_data
from linkpred_tpu_torch.models import twowl as m


def _toy_twowl_data(n_nodes=24, seed=0, ei2_bucket=256):
    """A chain through every node plus 60 random pairs, split and built as
    the JAX entry point builds it."""
    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(n_nodes - 1), np.arange(1, n_nodes)], axis=1)
    extra = np.stack(
        [rng.integers(0, n_nodes, 60), rng.integers(0, n_nodes, 60)], axis=1
    )
    pairs = np.concatenate([chain, extra], axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return build_twowl_data(pairs, n_nodes, rng=rng, ei2_bucket=ei2_bucket)


def entry(device=None, agg_1wl: str = "plan"):
    """(fn, example_args): the LocalWLNet forward scoring the toy graph's
    test split, `fn(*example_args)`, with parameters drawn from seed 0 on
    `device` (None: the visible card; no card raises). `agg_1wl='ell'` runs
    the 1-WL aggregation on kernel K1 and the 2-WL one on K3; 'plan', the
    default and the JAX entry point's choice, runs both in plain PyTorch."""
    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    d = _toy_twowl_data()
    cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=16,
                        channels_2wl=8, depth1=2, depth2=2, agg_1wl=agg_1wl)
    params = m.init_params(cfg, torch.Generator().manual_seed(0), device)

    def fn(params, node_deg, arrays):
        return m.eval_scores(params, node_deg, arrays, cfg)

    args = (params, torch.as_tensor(d.node_deg, dtype=torch.long,
                                    device=device),
            m.SplitArrays.from_split(d.test, device))
    return fn, args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of every mesh-parallel path at tiny shapes over a (n/2, 2)
    ("data", "edge") mesh, called by each rank of an initialized world of
    `n_devices` ranks (`device`: this rank's; None: its card). Rank 0
    prints a line per stanza:

    - the TwoWL step with the ei2 slots split over ``edge``, and one SGD
      step of it against the unsplit step (max |dparam| < 1e-5);
    - the SEAL step with the subgraph batch split over the whole mesh;
    - the trial-major TwoWL sweep with the trial axis split over ``data``;
    - `train_collab` node-sharded over ``edge`` at a tiny config;
    - the pipelined node-sharded SpMM against the dense adjacency;
    - the halo SpMM, forward and gradient, against the dense adjacency;
    - distributed SGNS over a (n,) ("data",) mesh: the corpus split over
      the ranks, both tables split on the feature dim."""
    import torch.distributed as dist

    from linkpred_tpu_torch.data.graph import Graph
    from linkpred_tpu_torch.models import seal
    from linkpred_tpu_torch.parallel import dp, make_mesh
    from linkpred_tpu_torch.parallel.collectives import (all_gather_blocks,
                                                         max_spread)
    from linkpred_tpu_torch.parallel.halo import HaloLayout, spmm_halo_sym
    from linkpred_tpu_torch.parallel.mesh import dim_rank
    from linkpred_tpu_torch.parallel.spmm_shard import (
        build_node_sharded_buckets, node_sharded_operands,
        spmm_node_sharded_pipelined)
    from linkpred_tpu_torch.pipelines.gcn_scale import (ScaleGCNConfig,
                                                        train_collab)

    if device is None:
        from linkpred_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs on every "
                           f"rank of a world of {n_devices} ranks")
    world = dist.group.WORLD
    mesh = make_mesh(n_devices, device_type=device.type)
    edge = mesh.get_group("edge")

    def say(line):
        if dist.get_rank() == 0:
            print(line, flush=True)

    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on "
        f"{n_devices} ranks ({dist.get_backend()}, {device.type})")

    # ---- TwoWL training step, ei2 slots split over `edge` --------------
    d = _toy_twowl_data(ei2_bucket=16 * n_devices)
    cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=16,
                        channels_2wl=8, depth1=2, depth2=2,
                        learning_rate=0.01, agg_1wl="ell")
    s = d.train
    placed = dp.shard_twowl_split(mesh, s, device)
    P = min(4, s.num_msg // 2, len(s.pred) // 2)
    pos_ids = torch.arange(P, device=device)
    neg_ids = torch.arange(P, device=device)

    def step(params, opt, arrays):
        gen = torch.Generator(device=device).manual_seed(1)
        return m.train_step(params, opt, gen, pos_ids, neg_ids, arrays,
                            cfg, d.num_nodes)[0]

    params = dp.replicate(mesh, m.init_params(
        cfg, torch.Generator().manual_seed(0), device))
    opt = m.adam(params, cfg.learning_rate)
    dp.reduce_gradients_on_step(opt, world)
    loss = step(params, opt, placed)
    say(f"twowl edge-sharded step: loss {float(loss):.4f}")

    # sharded equals unsplit: one SGD step under both (Adam would turn the
    # all-reduce's rounding in tiny gradient components into lr-sized steps)
    def sgd_step(arrays):
        p0 = m.init_params(cfg, torch.Generator().manual_seed(0), device)
        sgd = torch.optim.SGD(m.tree_leaves(p0), lr=cfg.learning_rate)
        dp.reduce_gradients_on_step(sgd, world)
        return p0, step(p0, sgd, arrays)

    ref_p, ref_loss = sgd_step(m.SplitArrays.from_split(s, device))
    sh_p, sh_loss = sgd_step(placed)
    max_d = max(float((a - b).detach().abs().max()) for a, b in
                zip(m.tree_leaves(sh_p), m.tree_leaves(ref_p)))
    spread = max_spread(m.tree_leaves(sh_p), world)
    if max_d >= 1e-5:
        raise AssertionError(f"edge-sharded step diverged: max|dP| = {max_d}")
    say(f"twowl sharded-vs-replicated max |dparam|: {max_d:.2e} (loss diff "
        f"{abs(float(sh_loss) - float(ref_loss)):.2e}; across ranks "
        f"{spread:.2e})")

    # ---- SEAL DGCNN step, batch split over the whole mesh --------------
    rng = np.random.default_rng(0)
    B, K, F = 2 * n_devices, 16, 6
    adj = (rng.random((B, K, K)) < 0.2).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.transpose(0, 2, 1)
    a_tilde = adj + np.eye(K, dtype=np.float32)[None]
    d_inv = (1.0 / a_tilde.sum(axis=2)).astype(np.float32)
    x = rng.standard_normal((B, K, F)).astype(np.float32)
    node_mask = np.ones((B, K), dtype=bool)
    y = rng.integers(0, 2, size=B).astype(np.int64)
    threshold_k = 8
    batch = dp.shard_seal_batch(mesh, d_inv, a_tilde, x, node_mask, y,
                                device)
    sparams = dp.replicate(mesh, seal.init_params(
        torch.Generator().manual_seed(0), F, threshold_k, device))
    sopt = seal.adam(sparams, 1e-3)
    dp.reduce_gradients_on_step(sopt, world)
    keep = torch.rand((B, seal.DENSE_NODES),
                      generator=torch.Generator().manual_seed(2)) < 0.5
    rows = slice(dist.get_rank() * (B // n_devices),
                 (dist.get_rank() + 1) * (B // n_devices))
    sopt.zero_grad()
    sloss = seal.loss_fn(sparams, *batch, threshold_k, dropout_rate=0.5,
                         keep=keep[rows].to(device))
    sloss.backward()
    sopt.step()
    sloss = float(sloss.detach())
    say(f"seal data-parallel step: loss {sloss:.4f} (rank 0's "
        f"{B // n_devices} subgraphs of {B})")

    # ---- TwoWL trial-major sweep, trial axis split over `data` ---------
    T = 2 * n_devices
    tparams = m.init_params_trials(cfg, T, torch.Generator().manual_seed(3),
                                   device)
    tstate = m.adam_trials_init(tparams)
    lrs = torch.full((T,), 0.01, device=device)
    rates = m.TrialRates(*[torch.zeros(T, device=device)] * 4)
    tparams, tstate, lrs, rates = dp.shard_twowl_trials(
        mesh, tparams, tstate, lrs, rates)
    trn = m.SplitArrays.from_split(s, device)
    val = m.SplitArrays.from_split(d.val, device)
    E = 2
    _, aucs, _ = m.train_loop_trials(
        tparams, tstate, None, pos_ids.repeat(E, 1), neg_ids.repeat(E, 1),
        trn, val, torch.as_tensor(d.val.y, dtype=torch.float32,
                                  device=device),
        torch.as_tensor(d.node_deg, dtype=torch.long, device=device), cfg,
        lrs, d.num_nodes, rates)
    all_aucs = all_gather_blocks(aucs, mesh.get_group("data"))
    say(f"twowl trial-sharded sweep: {T} trials, mean val AUC "
        f"{float(all_aucs.mean()):.4f}")

    # ---- collab-scale GCN trainer, node-sharded aggregation ------------
    res = train_collab(
        ScaleGCNConfig(nodes=200, edges=800, steps=8, batch_edges=64,
                       emb_dim=8, hidden=16, max_degree=8, dtype="f32"),
        device=device, mesh=mesh, verbose=False)
    say(f"collab e2e (node-sharded): loss {res['loss_first_quarter']:.4f} "
        f"-> {res['loss_last_quarter']:.4f} on {res['shards']} shards")

    rng2 = np.random.default_rng(5)
    pr = np.stack([rng2.integers(0, 40, 150), rng2.integers(0, 40, 150)], 1)
    pr = pr[pr[:, 0] != pr[:, 1]]
    gg = Graph.from_undirected_edges(pr[:, 0], pr[:, 1], num_nodes=40)
    S, k = mesh.mesh.shape[1], dim_rank(mesh, "edge")
    rows_ps, _, stacked = build_node_sharded_buckets(gg, S)
    xx = rng2.standard_normal((40, 8)).astype(np.float32)
    dense = gg.dense_adjacency()

    def block(a, r):
        a = np.pad(a, ((0, r * S - a.shape[0]), (0, 0)))
        return torch.as_tensor(a[k * r:(k + 1) * r], device=device)

    outp = spmm_node_sharded_pipelined(
        edge, block(xx, rows_ps), 40, rows_ps,
        node_sharded_operands(stacked, k, device), chunks=2)
    outp = all_gather_blocks(outp, edge)[:40].cpu().numpy()
    pd = float(np.abs(outp - dense @ xx).max())
    if pd >= 1e-4:
        raise AssertionError(f"pipelined spmm off the dense product: {pd}")
    say(f"pipelined overlap spmm max |diff| vs dense: {pd:.2e}")

    # ---- halo-exchange node-sharded SpMM (boundary-only all_to_all) ----
    lay = HaloLayout.build(gg, S)
    xh = block(xx[lay.order], lay.rows_per_shard).requires_grad_()
    out = spmm_halo_sym(edge, xh, lay.operands(k, device))
    (out.float() ** 2).sum().backward()
    a_new = dense[lay.order][:, lay.order]
    ref = a_new @ xx[lay.order]
    got = all_gather_blocks(out.detach(), edge)[:40].cpu().numpy()
    grad = all_gather_blocks(xh.grad, edge)[:40].cpu().numpy()
    hd = max(float(np.abs(got - ref).max()),
             float(np.abs(grad - 2 * a_new.T @ ref).max()))
    if hd >= 1e-4:
        raise AssertionError(f"halo spmm off the dense product: {hd}")
    say(f"halo spmm fwd+grad ok (max |diff| {hd:.2e}): cut {lay.edge_cut} "
        f"edges, ghost capacity {lay.ghost_capacity} rows "
        f"({lay.collective_bytes_per_layer(8)} B/layer/rank)")

    # ---- distributed SGNS: corpus-sharded sampling + feature-sharded ----
    # tables (parallel.sgns module docstring)
    from linkpred_tpu_torch.models.word2vec import SGNSConfig
    from linkpred_tpu_torch.parallel.sgns import train_sgns_mesh

    smesh = make_mesh(n_devices, shape=(n_devices,), axis_names=("data",),
                      device_type=device.type)
    walks = rng2.integers(0, 40, (8 * n_devices, 10), dtype=np.int32)
    emb = train_sgns_mesh(
        6, walks, 40,
        SGNSConfig(dim=8 * n_devices, window=4, epochs=1, batch_size=256,
                   neg_pool=32),
        mesh=smesh)
    if emb.shape != (40, 8 * n_devices) or not np.isfinite(emb).all():
        raise AssertionError(f"distributed sgns: shape {emb.shape}, finite "
                             f"{bool(np.isfinite(emb).all())}")
    say(f"distributed sgns step: tables feature-sharded {n_devices}-way, "
        f"corpus {n_devices}-sharded")
    say("dryrun_multichip OK")
