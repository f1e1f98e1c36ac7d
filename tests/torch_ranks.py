"""Rank bodies of the port's multi-process CPU tests.

`linkpred_tpu_torch.parallel.multihost.launch` starts each rank in a fresh
interpreter, which imports the module of the function it runs: these live
here, apart from the test files, so that a rank imports torch and the port
and never JAX. Inputs and results cross the process boundary as numpy.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    return t.detach().float().cpu().numpy()


def _gather(x, group, n=None):
    from linkpred_tpu_torch.parallel.collectives import all_gather_blocks

    out = all_gather_blocks(x.detach().contiguous(), group)
    return _np(out if n is None else out[:n])


def _block(a, rows, shards, k):
    a = np.pad(a, ((0, rows * shards - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))
    return torch.as_tensor(np.ascontiguousarray(a[k * rows:(k + 1) * rows]))


# ---------------------------------------------------------------------------
# test_torch_parallel.py
# ---------------------------------------------------------------------------


def sharded_ops(rank, world, g, g_cap, x, t, edges):
    """Every sharded SpMM of `parallel.spmm_shard` on a (1, world) mesh."""
    from linkpred_tpu_torch.parallel import make_mesh
    from linkpred_tpu_torch.parallel import spmm_shard as S
    from linkpred_tpu_torch.parallel.mesh import dim_rank, shard_slice

    out = {"mesh_default": None}
    default = make_mesh(device_type="cpu")
    out["mesh_default"] = (default.mesh_dim_names,
                           tuple(default.mesh.shape))
    mesh = make_mesh(world, shape=(1, world), device_type="cpu")
    grp = mesh.get_group("edge")
    k = dim_rank(mesh, "edge")
    n = g.num_nodes
    rows, _, stacked = S.build_node_sharded_buckets(g, world)
    ops = S.node_sharded_operands(stacked, k, "cpu")
    xt = torch.as_tensor(x)
    out["node_sharded"] = _gather(S.spmm_node_sharded(grp, xt, n, rows, ops),
                                  grp, n)
    for chunks in (1, 2, 4):
        out[f"pipelined_{chunks}"] = _gather(S.spmm_node_sharded_pipelined(
            grp, _block(x, rows, world, k), n, rows, ops, chunks=chunks),
            grp, n)
    for name, graph in (("sym", g), ("sym_capped", g_cap)):
        rows_c, _, st = S.build_node_sharded_buckets(graph, world)
        ops_c = S.node_sharded_operands(st, k, "cpu")
        xv = torch.as_tensor(x[: graph.num_nodes]).requires_grad_()
        o = S.spmm_node_sharded_sym(grp, xv, graph.num_nodes, rows_c, ops_c)
        (o * _block(t[: graph.num_nodes], rows_c, world, k)).sum().backward()
        grad = xv.grad.clone()
        dist.all_reduce(grad, group=grp)  # the ranks' blocks: the whole
        out[name] = _gather(o, grp, graph.num_nodes)
        out[name + "_grad"] = _np(grad)
    src, dst, w = edges
    (sp, dp_, wp), mask = S.pad_edges_for_mesh([src, dst, w], world)
    sl = shard_slice(len(sp), world, k)
    xe = torch.as_tensor(x).requires_grad_()
    oe = S.spmm_edge_partitioned(
        grp, torch.as_tensor(sp[sl]).long(), torch.as_tensor(dp_[sl]).long(),
        xe, n, torch.as_tensor(wp[sl]), torch.as_tensor(mask[sl]))
    (oe * torch.as_tensor(t)).sum().backward()
    out["edge"], out["edge_grad"] = _np(oe), _np(xe.grad)
    return out


def twowl_sgd_step(rank, world, split, cfg, params_np, pos, neg, num_nodes):
    """One SGD step of TwoWL with the ei2 slots split over ``edge`` (a
    (1, world) mesh), from the given parameters; and the same step on the
    whole split in this process."""
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.parallel import dp, make_mesh
    from linkpred_tpu_torch.parallel.collectives import max_spread

    mesh = make_mesh(world, shape=(1, world), device_type="cpu")
    out = {}
    for name, arrays in (("sharded", dp.shard_twowl_split(mesh, split, "cpu")),
                         ("whole", m.SplitArrays.from_split(split, "cpu"))):
        params = dp.replicate(mesh, m.params_from_jax(params_np, "cpu"))
        sgd = torch.optim.SGD(m.tree_leaves(params), lr=cfg.learning_rate)
        dp.reduce_gradients_on_step(sgd, dist.group.WORLD)
        loss, logits, _ = m.train_step(params, sgd, None, torch.as_tensor(pos),
                                       torch.as_tensor(neg), arrays, cfg,
                                       num_nodes)
        out[name] = ([_np(p) for p in m.tree_leaves(params)], float(loss),
                     _np(logits))
        out[name + "_spread"] = max_spread(m.tree_leaves(params),
                                           dist.group.WORLD)
    out["slots_here"] = int(dp.shard_twowl_split(
        mesh, split, "cpu").e1_cops[0].k3[2].shape[0])
    return out


def seal_dp_step(rank, world, params_np, batch, lr, keep):
    """One SGD step of the DGCNN with the batch split over the whole mesh
    (a (world / 2, 2) mesh), in eval mode and with the whole batch's
    dropout mask given."""
    from linkpred_tpu_torch.models import seal
    from linkpred_tpu_torch.parallel import dp, make_mesh

    mesh = make_mesh(world, device_type="cpu")
    local = dp.shard_seal_batch(mesh, *batch, "cpu")
    per = batch[0].shape[0] // world
    out = {}
    for name, rate in (("eval", 0.0), ("masks", 0.5)):
        params = dp.replicate(mesh, seal.params_from_jax(params_np, "cpu"))
        sgd = torch.optim.SGD(seal.leaves(params), lr=lr)
        dp.reduce_gradients_on_step(sgd, dist.group.WORLD)
        loss = seal.loss_fn(params, *local[:4], local[4], 8,
                            dropout_rate=rate,
                            keep=torch.as_tensor(
                                keep[rank * per:(rank + 1) * per]))
        loss.backward()
        sgd.step()
        out[name] = [_np(p) for p in seal.leaves(params)]
    return out


def trial_sweep(rank, world, split_trn, split_val, cfg, params_np, T, pos,
                neg, val_y, node_deg, num_nodes):
    """`train_loop_trials` with the trial axis split over ``data`` (a
    (world, 1) mesh); every trial's val AUCs and losses, gathered."""
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.parallel import dp, make_mesh

    mesh = make_mesh(world, shape=(world, 1), device_type="cpu")
    params = m.params_from_jax(params_np, "cpu")
    lrs = torch.full((T,), 1e-3)
    rates = m.TrialRates(*[torch.zeros(T)] * 4)
    p, s, l, r = dp.shard_twowl_trials(mesh, params,
                                       m.adam_trials_init(params), lrs, rates)
    _, best, (losses, aucs) = m.train_loop_trials(
        p, s, None, torch.as_tensor(pos), torch.as_tensor(neg),
        m.SplitArrays.from_split(split_trn, "cpu"),
        m.SplitArrays.from_split(split_val, "cpu"),
        torch.as_tensor(val_y, dtype=torch.float32),
        torch.as_tensor(node_deg, dtype=torch.long), cfg, l, num_nodes, r)
    grp = mesh.get_group("data")
    return {"trials_here": int(l.shape[0]),
            "aucs": _gather(aucs.T.contiguous(), grp).T,
            "losses": _gather(losses.T.contiguous(), grp).T,
            "best": _gather(best, grp)}


def collab(rank, world, cfgs, builts, params_np, reference_draws):
    """`train_sharded` for each config over a (1, world) mesh, from the
    given parameters, drawing its pairs as `reference_draws` says; rank 0's
    result and losses, and the weights' largest difference across ranks."""
    from linkpred_tpu_torch.parallel import make_mesh
    from linkpred_tpu_torch.parallel.collectives import max_spread
    from linkpred_tpu_torch.pipelines import gcn_scale as gs

    mesh = make_mesh(world, shape=(1, world), device_type="cpu")
    outs = []
    for cfg, built, draw in zip(cfgs, builts, reference_draws):
        params = gs.params_from_jax(params_np, "cpu")
        res, local, losses = gs.train_sharded(cfg, mesh, "cpu", built, params,
                                              reference_draw=draw)
        res["spread"] = max_spread([local[k] for k in
                                    ("w1", "w1s", "w2", "w2s")],
                                   mesh.get_group("edge"))
        outs.append((res, losses))
    return outs


def dryrun(rank, world):
    """`dryrun_multichip` on the CPU: the lines rank 0 printed (none on the
    other ranks)."""
    import contextlib
    import io

    from linkpred_tpu_torch.graft_entry import dryrun_multichip

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        dryrun_multichip(world, device="cpu")
    return printed.getvalue().splitlines()


def seal_must_divide(rank, world, batch):
    """The error `dp.shard_seal_batch` raises for a batch that does not
    divide over the mesh."""
    from linkpred_tpu_torch.parallel import dp, make_mesh

    try:
        dp.shard_seal_batch(make_mesh(world, device_type="cpu"), *batch,
                            "cpu")
    except ValueError as e:
        return str(e)
    return None


def parallel_all(rank, world, cases):
    """Each case of `cases` ({name: args}) by the rank body of that name,
    in one job: a job's start costs more than most of its bodies."""
    bodies = {"ops": sharded_ops, "twowl": twowl_sgd_step,
              "seal": seal_dp_step, "seal_divide": seal_must_divide,
              "trials": trial_sweep, "collab": collab, "dryrun": dryrun}
    out, seconds = {}, {}
    for name, args in cases.items():
        t0 = time.perf_counter()
        out[name] = bodies[name](rank, world, *args)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    out["jax_modules"] = jax_modules()
    return out


def jax_modules() -> list:
    """The modules of JAX, optax or the JAX package this rank loaded (the
    arguments it unpickled included): none, or the rank paid for them."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "optax", "linkpred_tpu", "benchmarks"))


# ---------------------------------------------------------------------------
# test_torch_halo.py
# ---------------------------------------------------------------------------


def halo_job(rank, world, layouts, x, t):
    """`halo_ops`, and the JAX modules the rank loaded."""
    return halo_ops(rank, world, layouts, x, t), jax_modules()


def halo_ops(rank, world, layouts, x, t):
    """`spmm_halo` and `spmm_halo_sym` (forward and gradient) of each
    layout of `layouts` ({name: (HaloLayout, exchange dtype name or None)})
    over a (1, world) mesh, on relabelled inputs, gathered (the gradient
    with the padding rows of the last block); and the gradient's shape for
    an input block one row shorter than `rows_per_shard`."""
    from linkpred_tpu_torch.parallel import make_mesh
    from linkpred_tpu_torch.parallel import halo as H
    from linkpred_tpu_torch.parallel.mesh import dim_rank

    mesh = make_mesh(world, shape=(1, world), device_type="cpu")
    grp, k = mesh.get_group("edge"), dim_rank(mesh, "edge")
    x_all, t_all = x, t
    out = {}
    for name, (lay, xd) in layouts.items():
        x = x_all[: lay.num_nodes]
        t = t_all[: lay.num_nodes]
        n = lay.num_nodes
        ops = lay.operands(k, "cpu")
        rows = lay.rows_per_shard
        xd = getattr(torch, xd) if xd else None
        xb = _block(x[lay.order], rows, world, k).requires_grad_()
        fwd = H.spmm_halo(grp, xb.detach(), ops, exchange_dtype=xd)
        sym = H.spmm_halo_sym(grp, xb, ops, exchange_dtype=xd)
        (sym * _block(t[lay.order], rows, world, k)).sum().backward()
        out[name] = _gather(fwd, grp, n)
        out[name + "_sym"] = _gather(sym, grp, n)
        out[name + "_grad"] = _gather(xb.grad, grp)
        # a shorter block than rows_per_shard: output and gradient keep
        # its rows
        short = xb.detach()[: rows - 1].clone().requires_grad_()
        H.spmm_halo_sym(grp, short, ops).sum().backward()
        out[name + "_short"] = tuple(short.grad.shape)
    return out


# ---------------------------------------------------------------------------
# test_torch_multihost.py
# ---------------------------------------------------------------------------


def multihost_job(rank, world, data, steps, opt, outdir, tag,
                  interrupt_at=0, resume=False):
    """The multi-host proof of the reference (`benchmarks/multihost_worker`)
    for the port: a ("host", "data", "edge") = (2, 1, 2) mesh over the four
    ranks, TwoWL with the ei2 slots split over ``edge`` and SEAL with the
    batch split over the whole mesh, `steps` steps of `opt` ("sgd" or
    "adam"); with `interrupt_at` every rank saves at that step and exits
    with 17, and `resume` restarts from that checkpoint."""
    from linkpred_tpu_torch.models import seal
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.parallel import dp
    from linkpred_tpu_torch.parallel.collectives import max_spread
    from linkpred_tpu_torch.parallel.distributed import hybrid_mesh
    from linkpred_tpu_torch.parallel.multihost import (fetch_replicated,
                                                       global_mesh,
                                                       global_twowl_split,
                                                       sync)

    mesh = hybrid_mesh((1, 2), (2,), ("host", "data", "edge"),
                       device_type="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == dict(zip(
        ("host", "data", "edge"),
        global_mesh((2, 1, 2), ("host", "data", "edge"), "cpu").mesh.shape))
    world_group = dist.group.WORLD
    make_opt = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}[opt]

    placed = global_twowl_split(mesh, data["split"], "cpu")
    params = m.params_from_jax(data["twowl_params"], "cpu")
    optimizer = make_opt(m.tree_leaves(params), lr=data["cfg"].learning_rate)
    dp.reduce_gradients_on_step(optimizer, world_group)
    ckpt = os.path.join(outdir, f"ckpt_twowl-{interrupt_at}.pt")
    start = 0
    if resume:
        state = torch.load(ckpt)
        with torch.no_grad():
            for p, v in zip(m.tree_leaves(params), state["params"]):
                p.copy_(v)
        optimizer.load_state_dict(state["opt"])
        start = interrupt_at
    losses = []
    for step in range(start, steps):
        pos, neg = data["batches"][step]
        gen = torch.Generator().manual_seed(1000 + step)
        loss, _, _ = m.train_step(params, optimizer, gen, torch.as_tensor(pos),
                                  torch.as_tensor(neg), placed, data["cfg"],
                                  data["num_nodes"])
        losses.append(float(fetch_replicated(loss)))
        if interrupt_at and not resume and step + 1 == interrupt_at:
            if rank == 0:
                torch.save({"params": [p.detach() for p in
                                       m.tree_leaves(params)],
                            "opt": optimizer.state_dict()}, ckpt)
            sync("ckpt_twowl")
            os._exit(17)
    twowl_final = fetch_replicated(m.tree_leaves(params))
    twowl_spread = max_spread(m.tree_leaves(params), world_group)

    sp = seal.params_from_jax(data["seal_params"], "cpu")
    sopt = make_opt(seal.leaves(sp), lr=1e-3)
    dp.reduce_gradients_on_step(sopt, world_group)
    batch = dp.shard_seal_batch(mesh, *data["seal_batch"], "cpu")
    per = data["seal_batch"][0].shape[0] // world
    seal_losses = []
    for step in range(steps):
        keep = data["seal_keep"][step][rank * per:(rank + 1) * per]
        sopt.zero_grad()
        sloss = seal.loss_fn(sp, *batch[:4], batch[4], 8, dropout_rate=0.5,
                             keep=torch.as_tensor(keep))
        sloss.backward()
        sopt.step()
        total = sloss.detach().clone()
        dist.all_reduce(total)
        seal_losses.append(float(total) / world)
    return {"processes": dist.get_world_size(), "tag": tag,
            "jax_modules": jax_modules(),
            "twowl_losses": losses, "seal_losses": seal_losses,
            "twowl_params": twowl_final,
            "seal_params": fetch_replicated(seal.leaves(sp)),
            "spread": max(twowl_spread,
                          max_spread(seal.leaves(sp), world_group))}


def multihost_jobs(rank, world, data, steps, outdir):
    """The uninterrupted runs of `multihost_job`, SGD then Adam, in one
    job."""
    return [multihost_job(rank, world, data, steps, opt, outdir, opt)
            for opt in ("sgd", "adam")]


# ---------------------------------------------------------------------------
# test_torch_sgns_mesh.py and test_torch_walks_mesh.py
# ---------------------------------------------------------------------------


def sgns_mesh_job(rank, world, cases):
    """`train_sgns_mesh` for each case of `cases` ({name: (seed, walks,
    num_nodes, cfg)}) over a (world,) ("data",) mesh: each case's table,
    and the JAX modules the rank loaded."""
    from linkpred_tpu_torch.parallel import make_mesh
    from linkpred_tpu_torch.parallel.sgns import train_sgns_mesh

    mesh = make_mesh(world, shape=(world,), axis_names=("data",),
                     device_type="cpu")
    out = {name: train_sgns_mesh(seed, walks, n, cfg, mesh=mesh)
           for name, (seed, walks, n, cfg) in cases.items()}
    out["jax_modules"] = jax_modules()
    return out


def walks_mesh_job(rank, world, cases):
    """Each case of `cases` ({name: (kind, args)}) on a mesh of the world:
    "routed" runs `TableShardedWalker.walks` (args: the layout, the mesh
    shape and dim names, seed, walks, length, capacity per destination);
    "sharded" runs `sharded_walks` (args: the graph, the mesh shape and dim
    names, seed, walks, length). Each case's (walks, walkers lost), and the
    JAX modules the rank loaded."""
    from linkpred_tpu_torch.ops.walk import WalkEngine
    from linkpred_tpu_torch.parallel import make_mesh
    from linkpred_tpu_torch.parallel.walks import sharded_walks

    out = {}
    for name, (kind, args) in cases.items():
        if kind == "routed":
            layout, shape, names, seed, num_walks, length, cap = args
            mesh = make_mesh(world, shape=shape, axis_names=names,
                             device_type="cpu")
            out[name] = layout.walks(mesh, torch.Generator().manual_seed(seed),
                                     num_walks, length,
                                     capacity_per_dest=cap)
        else:
            g, shape, names, seed, num_walks, length = args
            mesh = make_mesh(world, shape=shape, axis_names=names,
                             device_type="cpu")
            out[name] = (sharded_walks(mesh, WalkEngine(g, device="cpu"), seed,
                                       num_walks, length).numpy(), 0)
    out["jax_modules"] = jax_modules()
    return out


# ---------------------------------------------------------------------------
# test_torch_cuda.py: gloo ranks that share the one card
# ---------------------------------------------------------------------------


def card_job(rank, world, g, x, t, twowl_args):
    """On `cuda:0`, over a (1, world) gloo mesh: the node-sharded SpMM and
    its gradient, the pipelined form, the halo SpMM and its gradient, each
    against K3's plain version on the same operands; the TwoWL step with
    the slots split over the ranks against the whole split's, both on K1
    and K3. Returns the largest errors and this rank's kernel launches."""
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.ops import hopper_kernels as hk
    from linkpred_tpu_torch.parallel import dp, make_mesh
    from linkpred_tpu_torch.parallel import halo as H
    from linkpred_tpu_torch.parallel import spmm_shard as S
    from linkpred_tpu_torch.parallel.collectives import max_spread
    from linkpred_tpu_torch.parallel.mesh import dim_rank

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(world, shape=(1, world), device_type="cuda")
    grp, k = mesh.get_group("edge"), dim_rank(mesh, "edge")
    n = g.num_nodes
    before = dict(hk.LAUNCHES)
    err = {}

    def plain(xx, ops):
        return hk.spmm_bucketed_reference(xx, *ops)

    rows, _, stacked = S.build_node_sharded_buckets(g, world)
    ops = S.node_sharded_operands(stacked, k, dev)
    xd = torch.as_tensor(x, device=dev).requires_grad_()
    out = S.spmm_node_sharded_sym(grp, xd, n, rows, ops)
    tk = _block(t, rows, world, k).to(dev)
    (out * tk).sum().backward()
    g_full = torch.as_tensor(np.pad(t, ((0, rows * world - n), (0, 0))),
                             device=dev)
    err["node_sharded"] = float((out.detach() - plain(xd.detach(), ops))
                                .abs().max())
    own = slice(k * rows, min((k + 1) * rows, n))
    err["node_sharded_grad"] = float(
        (xd.grad[own] - plain(g_full, ops)[: own.stop - own.start])
        .abs().max())
    for chunks in (1, 2):
        p = S.spmm_node_sharded_pipelined(
            grp, _block(x, rows, world, k).to(dev), n, rows, ops, chunks)
        err[f"pipelined_{chunks}"] = float((p - out.detach()).abs().max())
    lay = H.HaloLayout.build(g, world)
    rows_h = lay.rows_per_shard
    xb = _block(x[lay.order], rows_h, world, k).to(dev).requires_grad_()
    h = H.spmm_halo_sym(grp, xb, lay.operands(k, dev))
    (h * _block(t[lay.order], rows_h, world, k).to(dev)).sum().backward()
    # the plain version: K3's on the relabelled graph's node-sharded
    # operands, from the whole relabelled input (A is symmetric: the
    # gradient is A t)
    rel = S.node_sharded_operands(S.build_node_sharded_buckets(
        _relabelled(g, lay.order), world)[2], k, dev)

    def whole(a):
        return torch.as_tensor(np.pad(a[lay.order],
                                      ((0, rows_h * world - n), (0, 0))),
                               device=dev)

    err["halo"] = float((h.detach() - plain(whole(x), rel)).abs().max())
    err["halo_grad"] = float((xb.grad - plain(whole(t), rel)).abs().max())
    split, cfg, params_np, pos, neg, num_nodes = twowl_args
    losses = {}
    for name, arrays in (("sharded", dp.shard_twowl_split(mesh, split, dev)),
                         ("whole", m.SplitArrays.from_split(split, dev))):
        params = m.params_from_jax(params_np, dev)
        sgd = torch.optim.SGD(m.tree_leaves(params), lr=cfg.learning_rate)
        dp.reduce_gradients_on_step(sgd, dist.group.WORLD)
        loss, _, _ = m.train_step(params, sgd, None,
                                  torch.as_tensor(pos, device=dev),
                                  torch.as_tensor(neg, device=dev), arrays,
                                  cfg, num_nodes)
        losses[name] = ([p.detach() for p in m.tree_leaves(params)],
                        float(loss))
        err[name + "_spread"] = max_spread(m.tree_leaves(params),
                                           dist.group.WORLD)
    err["twowl_params"] = max(float((a - b).abs().max()) for a, b in zip(
        losses["sharded"][0], losses["whole"][0]))
    err["twowl_loss"] = abs(losses["sharded"][1] - losses["whole"][1])
    return err, {kk: v - before[kk] for kk, v in hk.LAUNCHES.items()}


def card_n2v_job(rank, world, g, walks, cfg):
    """On `cuda:0`, over a (world,) gloo mesh: `train_sgns_mesh` on
    `walks`, the routed walk of `g` (p = 2, q = 0.5) and `sharded_walks`;
    the table, both walk matrices and the walkers lost."""
    from linkpred_tpu_torch.ops.walk import WalkEngine
    from linkpred_tpu_torch.parallel import make_mesh
    from linkpred_tpu_torch.parallel.sgns import train_sgns_mesh
    from linkpred_tpu_torch.parallel.walks import (TableShardedWalker,
                                                   sharded_walks)

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(world, shape=(world,), axis_names=("data",),
                     device_type="cuda")
    emb = train_sgns_mesh(5, walks, g.num_nodes, cfg, mesh=mesh)
    routed, lost = TableShardedWalker.build(g, world, p=2.0, q=0.5).walks(
        make_mesh(world, shape=(world,), axis_names=("edge",),
                  device_type="cuda"), 1, 20, 8)
    repl = sharded_walks(mesh, WalkEngine(g, device=dev), 2, 20, 8)
    assert repl.device == dev
    return emb, routed, lost, repl.cpu().numpy()


def _relabelled(g, order):
    """`g` with node i renamed to its position in `order` (what the halo
    layout aggregates), for the plain comparison."""
    import dataclasses

    inv = np.empty(g.num_nodes, np.int64)
    inv[order] = np.arange(g.num_nodes)
    return dataclasses.replace(
        g, nbr=inv[g.nbr[order]].astype(np.int32), nbr_mask=g.nbr_mask[order],
        nbr_weight=None if g.nbr_weight is None else g.nbr_weight[order])
