"""The single-trial TwoWL epoch loop as a CUDA graph (`models/twowl.py`:
`_graph_path`, `_EpochGraph`, `train_loop`): which calls take it, what its
key holds, that the loop op by op is the epoch loop as it was written out
before the graph (bit for bit on the CPU, with `EPOCH_COUNTS` counting
eager epochs only), and, on a card, that replays give the loop op by op's
results bit for bit, capture again for a changed address, and show as
spans and counts.

The CPU cases run everywhere; the cases marked `cuda` skip without a card.
The file imports no JAX, so on a machine with a card it runs as

    python -m pytest tests/test_torch_epoch_graph.py -m cuda --noconftest -q
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from linkpred_tpu_torch.data.twowl import build_twowl_data
from linkpred_tpu_torch.models import twowl as tm
from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.parallel import dp
from linkpred_tpu_torch.pipelines import twowl_pipeline as tp
from linkpred_tpu_torch.utils import profiling
from linkpred_tpu_torch.utils.metrics import roc_auc

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

EPOCHS = 6


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(11)
    n = 30
    extra = np.stack([rng.integers(0, n, 80), rng.integers(0, n, 80)], axis=1)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    pairs = np.concatenate([chain, extra], axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    d = build_twowl_data(pairs, n, rng=rng, ei2_bucket=256)
    cfg = tm.TwoWLConfig(max_degree=d.max_degree, channels_1wl=8,
                         channels_2wl=8, depth1=1, depth2=1, agg_1wl="ell")
    pos, neg = (torch.from_numpy(a).long() for a in
                tp.batch_schedule(d, tp.TwoWLRunConfig(epochs=EPOCHS)))
    return d, cfg, pos, neg


def _counts() -> dict:
    return dict(tm.EPOCH_COUNTS)


def _moved(before: dict) -> dict:
    return {k: tm.EPOCH_COUNTS[k] - before[k] for k in before}


# -- which calls take the graph ---------------------------------------------


def _admitted(toy, *conditions, **given) -> bool:
    d, *_ = toy
    trn = tm.SplitArrays.from_split(d.train, "cpu")
    val = tm.SplitArrays.from_split(d.val, "cpu")
    sharded = dp.sharded_paired_sum(None)
    fresh_adam = SimpleNamespace(param_groups=[{"capturable": False}],
                                 state={})
    call = {"device": torch.device("cuda", 0), "optimizer": fresh_adam,
            "trn": trn, "val": val, "eval_every": 1, "lr_schedule": None}
    variants = {
        "cpu": {"device": torch.device("cpu")},
        "lr_schedule": {"lr_schedule": np.full(EPOCHS, 0.01)},
        "eval_every": {"eval_every": 2},
        "sharded_trn": {"trn": dataclasses.replace(trn, paired_sum=sharded)},
        "sharded_val": {"val": dataclasses.replace(val, paired_sum=sharded)},
        "stepped_not_capturable": {"optimizer": SimpleNamespace(
            param_groups=[{"capturable": True}, {"capturable": False}],
            state={"leaf": {"step": 1}})},
        "no_capturable_option": {"optimizer": SimpleNamespace(
            param_groups=[{"lr": 0.1}], state={})},
    }
    for name in conditions:
        call.update(variants[name])
    return tm._graph_path(**{**call, **given})


@pytest.mark.parametrize("condition", [
    "cpu", "lr_schedule", "eval_every", "sharded_trn", "sharded_val",
    "stepped_not_capturable", "no_capturable_option"])
def test_each_condition_routes_the_call_eager(toy, condition):
    """A CUDA call with an Adam that has not stepped yet, a val eval every
    epoch, no schedule and the composed paired sum takes the graph; CPU
    tensors, a schedule, `eval_every` > 1, a sharded paired sum on either
    split, an optimizer that stepped without `capturable` or one that has
    no such option each send it op by op."""
    assert _admitted(toy)
    assert _admitted(toy, optimizer=SimpleNamespace(
        param_groups=[{"capturable": True}], state={"leaf": {"step": 1}}))
    assert not _admitted(toy, condition)


def test_adam_stays_as_made_off_the_graph(toy):
    """`adam` makes torch's Adam with the defaults it had, `capturable`
    off; a loop op by op (here on the CPU) leaves it so, and once it has
    stepped that way a call on the card would not take the graph."""
    d, cfg, pos, neg = toy
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = tm.adam(p, 0.01)
    assert [g["capturable"] for g in opt.param_groups] == [False]
    trn, val = (tm.SplitArrays.from_split(s, "cpu") for s in (d.train, d.val))
    tm.train_loop(p, opt, torch.Generator().manual_seed(1), pos[:1], neg[:1],
                  trn, val, torch.from_numpy(d.val.y),
                  torch.from_numpy(d.node_deg).long(), cfg, d.num_nodes)
    assert [g["capturable"] for g in opt.param_groups] == [False]
    assert not tm._graph_path(torch.device("cuda", 0), opt, trn, val, 1,
                              None)


def test_signature_holds_addresses_not_values():
    """The graph's key: a tensor by address, shape, strides and dtype,
    through dataclasses, named tuples, tuples and lists."""
    @dataclasses.dataclass(frozen=True)
    class Holder:
        a: torch.Tensor
        rest: tuple

    x, y = torch.zeros(4), torch.ones(2, 3)
    sig = tm._signature(Holder(x, (y, 7, [x])))
    assert sig == tm._signature(Holder(x, (y, 7, [x])))
    assert sig != tm._signature(Holder(x.clone(), (y, 7, [x])))
    assert sig != tm._signature(Holder(x, (y.t(), 7, [x])))
    assert sig != tm._signature(Holder(x, (y, 8, [x])))
    x.add_(1.0)  # a value written in place keeps the key
    assert sig == tm._signature(Holder(x, (y, 7, [x])))


# -- the loop op by op is the loop as written before the graph --------------


def _written_out(params, optimizer, generator, pos_ids_epochs,
                 neg_ids_epochs, trn, val, val_y, node_deg, cfg, num_nodes,
                 early_stop=None, eval_every=1, init_best=None,
                 lr_schedule=None):
    """`train_loop`'s epoch loop as it read before the graph path, written
    out op by op: the reference the eager path is held to."""
    device = val_y.device
    E = pos_ids_epochs.shape[0]
    num_msg_v = val.num_msg
    val_sel = num_msg_v + torch.arange(val.num_rows - num_msg_v,
                                       device=device)
    val_msg_mask = torch.ones(num_msg_v, dtype=torch.bool, device=device)
    if init_best is None:
        init_best = (tm.tree_map(lambda p: p.detach().clone(), params), 0.0)
    best_params, best_auc, since = (*init_best, 0)[:3]
    best_leaves, leaves = tm.tree_leaves(best_params), tm.tree_leaves(params)
    best_auc = torch.as_tensor(best_auc, dtype=torch.float32, device=device)
    since_bound = int(since)
    since = torch.as_tensor(since, dtype=torch.long, device=device)
    losses = torch.zeros(E, device=device)
    aucs = torch.full((E,), -1.0, device=device)
    for epoch in range(E):
        if early_stop is not None and since_bound > early_stop:
            since_bound = int(since)
            if since_bound > early_stop:
                since = since + (E - epoch)
                break
        if lr_schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = float(lr_schedule[epoch])
        loss, _, _ = tm.train_step(params, optimizer, generator,
                                   pos_ids_epochs[epoch],
                                   neg_ids_epochs[epoch], trn, cfg,
                                   num_nodes)
        with torch.no_grad():
            losses[epoch] = loss
            if epoch % eval_every == eval_every - 1:
                logits = tm.forward(params, cfg, node_deg, val, val_msg_mask,
                                    val_sel)
                auc = roc_auc(val_y, logits)
                improved = auc > best_auc
                for b, p in zip(best_leaves, leaves):
                    b.copy_(torch.where(improved, p, b))
                best_auc = torch.where(improved, auc, best_auc)
                since = torch.where(improved, 0, since + 1)
                aucs[epoch] = auc
            else:
                since = since + 1
        since_bound += 1
    return best_params, best_auc, since, (losses, aucs)


# keyword arguments of each case; "init_best" gives the carried best AUC
# and epochs since it (a best no epoch beats, so early stop comes)
CASES = {
    "plain": {},
    "early_stop": {"early_stop": 1, "init_best": (2.0, 1)},
    "eval_every": {"eval_every": 2, "init_best": (0.0, 0)},
    "lr_schedule": {"lr_schedule": np.linspace(0.02, 0.002, EPOCHS)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_loop_is_the_loop_written_out(toy, case):
    """On the CPU, `train_loop` equals the loop written out bit for bit
    (losses, val AUCs, best AUC, epochs since it, parameters, best leaves,
    Adam's moments), dropout on, and `EPOCH_COUNTS` counts each epoch it
    ran as eager and nothing as replayed or captured."""
    d, cfg, pos, neg = toy
    kwargs = dict(CASES[case])
    runs, moved = [], None
    for loop in (_written_out, tm.train_loop):
        p = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = tm.adam(p, cfg.learning_rate)
        if "init_best" in CASES[case]:
            kwargs["init_best"] = (tm.tree_map(lambda t: t.detach().clone(),
                                               p), *CASES[case]["init_best"])
        before = _counts()
        best_p, best_auc, since, (losses, aucs) = loop(
            p, opt, torch.Generator().manual_seed(1), pos, neg,
            tm.SplitArrays.from_split(d.train, "cpu"),
            tm.SplitArrays.from_split(d.val, "cpu"),
            torch.from_numpy(d.val.y), torch.from_numpy(d.node_deg).long(),
            cfg, d.num_nodes, **kwargs)
        if loop is tm.train_loop:
            moved = _moved(before)
        state = [t for leaf in tm.tree_leaves(p)
                 for t in (opt.state[leaf]["exp_avg"],
                           opt.state[leaf]["exp_avg_sq"])]
        runs.append([best_auc, since, losses, aucs, *tm.tree_leaves(p),
                     *tm.tree_leaves(best_p), *state])
    for a, b in zip(*runs):
        assert torch.equal(torch.as_tensor(a).detach(),
                           torch.as_tensor(b).detach())
    ran = int((runs[1][2] != 0).sum()) if case == "early_stop" else EPOCHS
    assert moved == {"eager": ran, "replayed": 0, "captures": 0}
    if case == "early_stop":
        assert ran < EPOCHS  # the stop was reached


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from linkpred_tpu_torch.utils.device import cuda_device

    return cuda_device()


@pytest.fixture(scope="module")
def fb():
    run = tp.TwoWLRunConfig(epochs=12)
    data = tp.build_data(*tp.load_edges(), run, np.random.default_rng(0))
    return data, tp.batch_schedule(data, run)


def _card_run(fb, dev, agg: str, calls, graphed: bool, early_stop=None,
              best_auc: float = -1.0):
    """One seeded run of `sum(calls)` epochs in calls of `calls` epochs,
    carrying the best and the epochs since it as the benchmark's window
    does; `graphed` False takes the loop op by op through a gating input,
    a schedule that holds the configured rate, with Adam made `capturable`
    before its first step as the graph path makes it. Returns every
    output, the parameters, the best leaves and Adam's moments, and the
    counts moved."""
    data, (pos, neg) = fb
    cfg = tm.TwoWLConfig(max_degree=data.max_degree, agg_1wl=agg)
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = tm.adam(p, cfg.learning_rate)
    if not graphed:
        for group in opt.param_groups:
            group["capturable"] = True
    gen = torch.Generator(device=dev).manual_seed(1)
    trn = tm.SplitArrays.from_split(data.train, dev)
    val = tm.SplitArrays.from_split(data.val, dev)
    val_y = torch.as_tensor(data.val.y, device=dev)
    feat = tp.node_features(cfg, data, dev)
    pos, neg = (torch.as_tensor(a, dtype=torch.long, device=dev)
                for a in (pos, neg))
    best = (tm.tree_map(lambda t: t.detach().clone(), p),
            torch.tensor(best_auc, device=dev), 0)
    outs, start, before = [], 0, _counts()
    for n in calls:
        sched = None if graphed else np.full(n, cfg.learning_rate)
        best_p, best_auc, since, (losses, aucs) = tm.train_loop(
            p, opt, gen, pos[start:start + n], neg[start:start + n], trn,
            val, val_y, feat, cfg, data.num_nodes, init_best=best,
            lr_schedule=sched, early_stop=early_stop)
        best = (best_p, best_auc, since)
        outs += [losses, aucs, best_auc, since]
        start += n
    torch.cuda.synchronize(dev)
    moved = _moved(before)
    assert [g["capturable"] for g in opt.param_groups] == [True]
    state = [t for leaf in tm.tree_leaves(p)
             for t in (opt.state[leaf]["exp_avg"], opt.state[leaf]["exp_avg_sq"],
                       opt.state[leaf]["step"])]
    return (outs + tm.tree_leaves(p) + tm.tree_leaves(best[0]) + state,
            moved)


@pytest.mark.cuda
@pytest.mark.parametrize("agg, early_stop", [("ell", None), ("plan", None),
                                             ("ell", 2)])
def test_replays_equal_the_loop_op_by_op(fb, cuda, agg, early_stop):
    """12 epochs on fb-pages-food in calls of 1, 1 and 10, dropout on: the
    graphed run (eager, then capture and replays) and the run op by op
    agree bit for bit on every loss, val AUC, best AUC, the epochs since
    it, every parameter, best leaf and Adam moment. With an early stop of
    2 and a carried best that no epoch beats, both stop after 3 epochs,
    inside the last call, and count the frozen epochs alike."""
    best = -1.0 if early_stop is None else 2.0
    ran = 12 if early_stop is None else 3
    graphed, moved_g = _card_run(fb, cuda, agg, (1, 1, 10), True,
                                 early_stop, best)
    eager, moved_e = _card_run(fb, cuda, agg, (1, 1, 10), False, early_stop,
                               best)
    assert moved_g == {"eager": 1, "replayed": ran - 1, "captures": 1}
    assert moved_e == {"eager": ran, "replayed": 0, "captures": 0}
    assert len(graphed) == len(eager)
    for i, (a, b) in enumerate(zip(graphed, eager)):
        assert torch.equal(torch.as_tensor(a).cpu(),
                           torch.as_tensor(b).cpu()), i


@pytest.mark.cuda
def test_a_changed_address_captures_anew(fb, cuda):
    """A call that hands the loop a tensor at another address (a copy of
    the val labels) gets one epoch op by op and a new capture; calls with
    the same tensors replay. Replays launch no kernel from the host:
    `hopper_kernels.LAUNCHES` moves at captures only."""
    data, (pos, neg) = fb
    cfg = tm.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell")
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    opt = tm.adam(p, cfg.learning_rate)
    gen = torch.Generator(device=cuda).manual_seed(1)
    trn = tm.SplitArrays.from_split(data.train, cuda)
    val = tm.SplitArrays.from_split(data.val, cuda)
    val_y = torch.as_tensor(data.val.y, device=cuda)
    feat = tp.node_features(cfg, data, cuda)
    pos, neg = (torch.as_tensor(a, dtype=torch.long, device=cuda)
                for a in (pos, neg))
    best = (tm.tree_map(lambda t: t.detach().clone(), p), 0.0)

    def call(labels):
        before, launches = _counts(), sum(hk.LAUNCHES.values())
        tm.train_loop(p, opt, gen, pos[:3], neg[:3], trn, val, labels, feat,
                      cfg, data.num_nodes, init_best=best)
        torch.cuda.synchronize(cuda)
        return _moved(before), sum(hk.LAUNCHES.values()) - launches

    first, _ = call(val_y)
    assert first == {"eager": 1, "replayed": 2, "captures": 1}
    same, launched = call(val_y)
    assert same == {"eager": 0, "replayed": 3, "captures": 0}
    assert launched == 0
    moved, _ = call(val_y.clone())
    assert moved == {"eager": 1, "replayed": 2, "captures": 1}


@pytest.mark.cuda
def test_replayed_epochs_as_spans(fb, cuda):
    """Recording on, one call of 4 epochs: four `twowl.epoch` spans; the
    first holds the phases op by op, the second the `twowl.capture` (the
    phases inside it) and a `twowl.replay`, the last two a `twowl.replay`
    each and no phase; one `mark_step` event an epoch and one at the end."""
    data, (pos, neg) = fb
    cfg = tm.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell")
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    opt = tm.adam(p, cfg.learning_rate)
    trn = tm.SplitArrays.from_split(data.train, cuda)
    val = tm.SplitArrays.from_split(data.val, cuda)
    with profiling.recording() as rec:
        tm.train_loop(p, opt, torch.Generator(device=cuda).manual_seed(1),
                      torch.as_tensor(pos[:4], dtype=torch.long, device=cuda),
                      torch.as_tensor(neg[:4], dtype=torch.long, device=cuda),
                      trn, val, torch.as_tensor(data.val.y, device=cuda),
                      tp.node_features(cfg, data, cuda), cfg,
                      data.num_nodes)
        torch.cuda.synchronize(cuda)
    epochs = sorted((s for s in rec.spans if s.name == "twowl.epoch"),
                    key=lambda s: s.start_ns)
    assert len(epochs) == 4 and len(rec.steps) == 5
    children = [[c.name for c in sorted(
        (s for s in rec.spans if s.parent == e.id), key=lambda s: s.start_ns)]
        for e in epochs]
    assert children[0] == ["twowl.inputs", "twowl.forward", "twowl.backward",
                           "twowl.optimizer", "twowl.eval"]
    assert children[1] == ["twowl.capture", "twowl.replay"]
    assert children[2] == children[3] == ["twowl.replay"]
    (capture,) = [s for s in rec.spans if s.name == "twowl.capture"]
    inside = {s.name for s in rec.spans if s.parent == capture.id}
    assert inside == {"twowl.inputs", "twowl.forward", "twowl.backward",
                      "twowl.optimizer", "twowl.eval"}


@pytest.mark.cuda
def test_a_call_op_by_op_leaves_adam_as_made(fb, cuda):
    """A call on the card that the graph path does not admit (a val eval
    every second epoch, as `pipelines/twowl_scale` runs by default) runs
    op by op with Adam as `adam` made it: not `capturable`, its step
    counts on the host."""
    data, (pos, neg) = fb
    cfg = tm.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell")
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    opt = tm.adam(p, cfg.learning_rate)
    before = _counts()
    tm.train_loop(p, opt, torch.Generator(device=cuda).manual_seed(1),
                  torch.as_tensor(pos[:4], dtype=torch.long, device=cuda),
                  torch.as_tensor(neg[:4], dtype=torch.long, device=cuda),
                  tm.SplitArrays.from_split(data.train, cuda),
                  tm.SplitArrays.from_split(data.val, cuda),
                  torch.as_tensor(data.val.y, device=cuda),
                  tp.node_features(cfg, data, cuda), cfg, data.num_nodes,
                  eval_every=2)
    torch.cuda.synchronize(cuda)
    assert _moved(before) == {"eager": 4, "replayed": 0, "captures": 0}
    assert [g["capturable"] for g in opt.param_groups] == [False]
    steps = {opt.state[leaf]["step"].device.type
             for leaf in tm.tree_leaves(p)}
    assert steps == {"cpu"}
