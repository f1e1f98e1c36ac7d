"""The port's span recorder (`utils/profiling.py`) and its spans in the TwoWL
epoch loops and the kernel loader: off, a span costs a flag check and
changes nothing; on, each epoch is one `twowl.epoch` over its five phases,
on the torch profiler's clock too; a kernel compiled again shows by name.
Everything here runs on the CPU but the last case, which needs a card."""

import json
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from linkpred_tpu_torch.data.twowl import build_twowl_data
from linkpred_tpu_torch.kernels import build
from linkpred_tpu_torch.models import twowl as tm
from linkpred_tpu_torch.pipelines import twowl_pipeline as tp
from linkpred_tpu_torch.utils import profiling

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

PHASES = ["twowl.inputs", "twowl.forward", "twowl.backward",
          "twowl.optimizer", "twowl.eval"]
EPOCHS, TRIALS = 3, 2


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(7)
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
    static = (tm.SplitArrays.from_split(d.train, "cpu"),
              tm.SplitArrays.from_split(d.val, "cpu"),
              torch.from_numpy(d.val.y), torch.from_numpy(d.node_deg).long(),
              cfg)
    return d, cfg, pos, neg, static


def _run_loop(toy, loop: str):
    """A fresh seeded run of `loop` ("single": `train_loop`; "trials": a
    two-trial `train_loop_trials`) over the toy schedule; returns every
    output and the parameters after, as tensors."""
    d, cfg, pos, neg, static = toy
    gen = torch.Generator().manual_seed(1)
    if loop == "single":
        p = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        best, auc, since, (losses, aucs) = tm.train_loop(
            p, tm.adam(p, cfg.learning_rate), gen, pos, neg, *static,
            d.num_nodes)
        outs = [auc, since, losses, aucs]
    else:
        p = tm.init_params_trials(cfg, TRIALS,
                                  torch.Generator().manual_seed(0), "cpu")
        rates = tm.TrialRates(*(torch.full((TRIALS,), r) for r in
                                (0.5, 0.2, 0.4, 0.1)))
        best, auc, (losses, aucs) = tm.train_loop_trials(
            p, tm.adam_trials_init(p), gen, pos, neg, *static,
            torch.tensor([0.01, 0.003]), d.num_nodes, rates)
        outs = [auc, losses, aucs]
    leaves = tm.tree_leaves(p) + tm.tree_leaves(best)
    return outs + [t.detach() for t in leaves]


def test_span_off_is_a_flag_check(monkeypatch):
    """Off: `span` returns the one shared no-op context, reads no clock,
    opens no `record_function` and records nothing; `mark_step` records
    no event."""
    def refuse(*args, **kwargs):
        raise AssertionError("called while recording is off")

    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert profiling._recording is None
    assert profiling.span("a") is profiling.span("b") is profiling._NO_SPAN
    with profiling.span("a"), profiling.span("b"):
        profiling.mark_step(torch.device("cuda", 0))
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.steps == []


@pytest.mark.parametrize("loop", ["single", "trials"])
def test_recording_leaves_the_loops_bit_identical(toy, loop):
    off = _run_loop(toy, loop)
    with profiling.recording() as rec:
        on = _run_loop(toy, loop)
    assert rec.spans and rec.steps == []  # CPU: no card events
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("loop", ["single", "trials"])
def test_each_epoch_is_one_span_over_its_phases(toy, loop):
    with profiling.recording() as rec:
        _run_loop(toy, loop)
    epochs = [s for s in rec.spans if s.name == "twowl.epoch"]
    assert len(epochs) == EPOCHS
    assert all(s.parent is None for s in epochs)
    ids = {s.id for s in epochs}
    assert {s.parent for s in rec.spans if s.parent is not None} == ids
    for e in epochs:
        children = sorted((s for s in rec.spans if s.parent == e.id),
                          key=lambda s: s.start_ns)
        assert [c.name for c in children] == PHASES
        assert all(e.start_ns <= c.start_ns <= c.end_ns <= e.end_ns
                   for c in children)
        assert all(a.end_ns <= b.start_ns
                   for a, b in zip(children, children[1:]))


def test_self_time_by_hand(monkeypatch):
    """On a clock that ticks 1 ns a read: a (reads 0, 7) over b (1, 4) over
    c (2, 3), then d (5, 6): self times 7-3-1 = 3, 3-1 = 2, 1 and 1."""
    ticks = iter(range(100))
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    with profiling.recording() as rec:
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                pass
    by_name = {s.name: s for s in rec.spans}
    assert [(s.name, s.start_ns, s.end_ns) for s in rec.spans] == [
        ("c", 2, 3), ("b", 1, 4), ("d", 5, 6), ("a", 0, 7)]
    assert by_name["a"].parent is None
    assert by_name["b"].parent == by_name["d"].parent == by_name["a"].id
    assert by_name["c"].parent == by_name["b"].id
    own = profiling.self_ns(rec.spans)
    assert {n: own[s.id] for n, s in by_name.items()} == {
        "a": 3, "b": 2, "c": 1, "d": 1}


def test_spans_on_the_profiler_clock(toy):
    """Under a CPU `torch.profiler` the spans are host ranges of the same
    names, one a span, and each phase's range holds its own aten ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.recording() as rec:
        _run_loop(toy, "single")
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    for name in ["twowl.epoch"] + PHASES:
        ranges = [e for e in events if e[0] == name]
        assert len(ranges) == sum(s.name == name for s in rec.spans) == EPOCHS
    ops = {"twowl.forward": "aten::binary_cross_entropy_with_logits",
           "twowl.backward": "autograd::engine::evaluate_function: "
                             "BinaryCrossEntropyWithLogitsBackward0",
           "twowl.optimizer": "Optimizer.step#Adam.step"}
    for phase, op in ops.items():
        ranges = [e for e in events if e[0] == phase]
        inside = [o for o in events if o[0] == op
                  and any(a <= o[1] and o[2] <= b for _, a, b in ranges)]
        assert len(inside) == EPOCHS, (phase, op)


def test_device_trace_names_the_spans(tmp_path):
    """`device_trace` (the CLI's `--profile`) records spans: the written
    trace shows them as named ranges."""
    with profiling.device_trace(str(tmp_path), cuda=False):
        with profiling.span("twowl.epoch"):
            torch.ones(64).cumsum(0)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "twowl.epoch" for e in events)
    assert profiling._recording is None


@pytest.mark.parametrize("built", [True, False], ids=["present", "missing"])
def test_kernel_loader_spans(tmp_path, monkeypatch, built):
    """`kernels.load` on a source's first load; `kernels.compile` inside it
    only when the hashed library is missing (`nvcc` and the loader faked);
    a second load is cached and records nothing."""
    lib = tmp_path / "libfake-0123.so"
    if built:
        lib.write_bytes(b"")

    def nvcc(cmd, **kwargs):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBRARIES", {})
    monkeypatch.setattr(build, "library_path", lambda name: lib)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("loaded", path))
    with profiling.recording() as rec:
        assert build.library("fake") == ("loaded", str(lib))
        build.library("fake")
    names = [s.name for s in rec.spans]
    assert names == (["kernels.load"] if built
                     else ["kernels.compile", "kernels.load"])
    if not built:
        compile_, load = rec.spans
        assert compile_.parent == load.id and lib.exists()


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from linkpred_tpu_torch.utils.device import cuda_device

    return cuda_device()


@pytest.mark.cuda
def test_step_events_time_each_epoch_on_the_card(toy, cuda):
    """On a card: one start event an epoch and one at the loop's end, so
    `step_ms` gives one positive interval an epoch, in each of two calls."""
    dev = cuda
    d, cfg, pos, neg, static = toy
    trn, val, val_y, feat, _ = static
    static = (tm.SplitArrays.from_split(d.train, dev),
              tm.SplitArrays.from_split(d.val, dev), val_y.to(dev),
              feat.to(dev), cfg)
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = tm.adam(p, cfg.learning_rate)
    with profiling.recording() as rec:
        for _ in range(2):
            tm.train_loop(p, opt, None, pos.to(dev), neg.to(dev), *static,
                          d.num_nodes)
        torch.cuda.synchronize(dev)
    assert len(rec.steps) == 2 * (EPOCHS + 1)
    ms = rec.step_ms()
    assert len(ms) == 2 * EPOCHS and all(v > 0 for v in ms)
