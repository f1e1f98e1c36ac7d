#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`linkpred_tpu_torch`) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only scale,n2v   # some groups, while working

Builds kernels K1, K3 and K2 (with K2's gradient) and the row gather from
`linkpred_tpu_torch/csrc/` (one nvcc per source, all at once), holds each
against its plain PyTorch version on the card, times it beside its bound
(the bytes it must move over the card's memory rate) and beside one PyTorch
library call for the same function (the row gather at both benchmark cells'
shapes, with its launch shape and PyTorch's), and drives the port's paths
through the entry points a user calls:
TwoWL on fb-pages-food at the published-best widths (`train_routine_fused`,
`run_twowl`; K1 and K3), collab-scale GCN training at the full published
config (`train_collab`, `cli scale --family gcn`; K3, K2 and K2's gradient,
two identical runs bitwise equal, and the step's device time beside the
parent build's plain gradient), and the
trial-major TwoWL sweep (`refine_vmapped` 32 trials x 1000 epochs,
`refine_halving`, `refine_adaptive`, `cli twowl --refine`; K1 and K3),
node2vec walks and SGNS embeddings with the logistic family
(`WalkEngine`, `train_sgns_device`, `run_logistic`; no kernel of its own)
beside the host plane's C++ (`native.sgns_train_ref`, gensim's SGNS loop on
the host's cores, and `native.build_csr_ell` on the collab graph against its
numpy path),
TwoWL at 50k nodes at the full published config (`run_twowl_scale`, `cli
scale --family twowl`; K1 at `[50000, 32]` slots and K3 in bf16 over the
capped ei2 structure), and SEAL (DRNL on the card against the C++ plane,
`run_seal` at the reference defaults, `run_seal_scale` at collab scale, `cli
seal`, `cli scale --family seal`; no kernel of its own) with the rest of the
ops (`spmm_auto`'s regimes, `spmm_ell_auto` on K1, `sddmm_auto` on K2), and
the user surface (`graft_entry.entry()` on 'plan' and on K1 and K3, `cli
--profile-dir` naming K1's and K3's kernels in its trace, `cli --set`, `cli
report` and `stats --no-plot`, and the TwoWL seed band's floor at 1,000
epochs), and the multi-GPU stack (`linkpred_tpu_torch.parallel`) as four
gloo ranks that share the card: the collectives gloo takes on CUDA
tensors, the node-sharded, pipelined and halo SpMMs on K3 at collab scale
and at both of the GCN's widths, the TwoWL step with the ei2 slots split over the ranks and the
trial-sharded sweep on K1 and K3, SEAL's data-parallel step, the dry run,
`train_collab` node-sharded and halo at the full config on K3 and K2, the
distributed node2vec (the routed and the replicated walks on fb-pages-food
and the collab graph, `train_sgns_mesh` at the logistic family's config and
at 235,000 x 128, each held to its one-card or one-process counterpart),
`torchrun --nproc-per-node 1 ... scale --family gcn` on NCCL, and
`train_sharded`'s, `train_sgns_mesh`'s and the routed walk's collectives
over a one-rank NCCL mesh). Every path an AUC gate reads also runs twice in
this process from one seed, at a cut depth, in a repeat phase whose
readings (tables, losses, AUCs) must agree bit for bit (`e_slice_repeat`,
`p_sweep_repeat`, `u_sgns_repeat`, `v_logistic_repeat`, `w_scale_repeat`,
`seal_repeat`, `par_collab_repeat`, `dn_sgns_repeat`, and the GCN's
`k_gcn_repeat`). One line per phase; every timing of K3 names
the device kernel the profiler saw for the timed call (`device_kernel`:
which of K3's four kernels the shape took, and at what group and rows a
warp). Then one JSON line of kernel results, the card's name and power
limit as nvidia-smi gives them, and last `{"ok": true, "device": {...}}`.
Nothing catches a failed phase: without a card, or without the rest of the
repository, it raises and exits non-zero before printing any result. With
`--only` (groups `slice`, `gcn`, `sweep`, `n2v`, `scale`, `seal`,
`surface`, `parallel`, `gather`) only those
groups' phases run and the run ends with a line `{"partial": [...]}` in place
of the kernels line and the last line: a partial run proves nothing about the
rest.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

K1_TOL = 1e-5  # max abs error of K1 against its plain version (f32 sums)
LOSS_RTOL = 1e-3  # 'ell' vs 'plan' loss histories, phase (d)
VAL_AUC_FLOOR = 0.65  # best val AUC after 200 epochs (JAX on CPU: 0.731)
# K3 / K2 against their plain versions: f32 as K1; bf16 outputs of K3 are
# f32 sums rounded once, in another order than the plain version's, so
# they may differ by one bf16 ulp (rtol 2^-7); K2 returns f32 sums
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=1e-6)
K2_TOL = dict(rtol=1e-5, atol=1e-4)
# test AUC after 60 steps: the JAX package's band on the CPU over seeds 0-4
# is 0.90773 to 0.91057 (tests/test_torch_bands.py), the floor its minimum
# less 0.01; phase (j) runs seed 0, the port's seed nearest the floor (its
# seeds 1 and 2 are cut to fit the smoke's time: ROADMAP F6)
GCN_AUC_FLOOR = 0.8977
GCN_SEEDS = (0,)
# the sweep of phase (p), bench.py's headline config: 32 trials x 1000
# epochs. The floors sit below the JAX package's own run of this config
# (CPU: winner test 0.9097, best val 0.8804) because the port's init draws
# differ from JAX's
SWEEP_TRIALS, SWEEP_EPOCHS = 32, 1000
SWEEP_TEST_FLOOR, SWEEP_VAL_FLOOR = 0.85, 0.80
# the repeat phases: each gated path run twice in this process from one seed
# and held bit for bit, at a depth cut to what shows a change of summation
# order (the first steps of a run)
REPEAT_SLICE_EPOCHS, REPEAT_SWEEP_EPOCHS, REPEAT_SCALE_EPOCHS = 50, 20, 8
REPEAT_SEAL_EPOCHS, PAR_REPEAT_STEPS, PAR_REPEAT_SGNS_ROWS = 2, 5, 4096
TURN_EPOCHS = 100  # the sweep in turns 'ell', 'plan', 'plan', 'ell'
REFINE_EPOCHS = 100  # phase (q)
# the logistic family, phase (v): test AUC at seed 35 (seed 36 cut to fit
# the smoke's time: ROADMAP F6; dn_sgns holds the same floor from the
# distributed embeddings) (the JAX package over 20 seeds: 0.7988 +- 0.013,
# min 0.7757)
LOGISTIC_AUC_FLOOR = 0.76
# TwoWL at 50k nodes, phase (w): test AUC after 96 epochs (the bar of the
# reference's gate for this config; its record is 0.9285)
SCALE_AUC_FLOOR = 0.85
SCALE_TURN_EPOCHS, SCALE_PARITY_EPOCHS = 8, 24
# SEAL, phase seal_run: test AUC at seed 0 after the reference's 50 epochs
# (seed 1 cut to fit the smoke's time: ROADMAP F6); the JAX package's band
# on the CPU over seeds 0-5 is 0.93780 to 0.94984
# (tests/test_torch_bands.py), the floor its minimum less 0.01
SEAL_AUC_FLOOR = 0.9278
SEAL_SEEDS = (0,)
# TwoWL on fb-pages-food, phase surface_band: one trial of the
# published-best architecture, 1,000 epochs with the early stop at 800, at
# seed 0 (seed 1 cut to fit the smoke's time: ROADMAP F6); the JAX
# package's band on the CPU over seeds 0-9 is 0.80883 to 0.88318
# (tests/test_torch_bands.py), the floor its minimum less 0.01
TWOWL_AUC_FLOOR = 0.7988
TWOWL_BAND_SEEDS = (0,)
# the keys `run_seal_scale` returns, those of the JAX package's
SEAL_SCALE_KEYS = {"nodes", "directed_edges", "hop", "target_pairs",
                   "subgraphs_per_s", "extract_seconds", "mean_subgraph_size",
                   "tags_size", "loss_first_quarter", "loss_last_quarter",
                   "loss_decreased", "test_auc", "train_seconds",
                   "compile_seconds", "build_seconds", "use_embedding"}
# the keys `run_twowl_scale` returns: the JAX package's plus operand_seconds
SCALE_KEYS = {"nodes", "msg_edges", "ei2_columns", "ei2_cap_per_node",
              "epochs", "loss_first_quarter", "loss_last_quarter",
              "loss_decreased", "best_val_auc", "test_auc", "train_seconds",
              "epochs_per_s", "compile_seconds", "build_seconds",
              "operand_seconds", "n2v_seconds", "node_feature"}
# the keys `train_collab` returns, those of the JAX package's `train_collab`
GCN_KEYS = {"nodes", "directed_edges", "shards", "aggregation", "steps",
            "loss_first_quarter", "loss_last_quarter", "loss_decreased",
            "test_auc", "train_seconds", "compile_seconds", "build_seconds",
            "steps_per_s", "agg_edges_per_s"}


T_START = time.perf_counter()


def phase(step, **kv):
    """One JSON line for a phase, with the seconds since the script began."""
    print(json.dumps({"phase": step, **kv,
                      "at_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


# idle time around the timed calls of a profiler capture, and the small
# kernels launched before and behind them (see `profiled_ms`)
PROFILE_PAD_S = 0.02
PROFILE_LEAD, PROFILE_TRAIL = 512, 4


def cuda_ms(fn, iters=200, warmup=20):
    """Mean milliseconds per call of `fn` on the card, by CUDA events around
    back-to-back calls: kernel time, or the host's issue time where that is
    longer (small kernels)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# readings of `kernel_ms` so far that rest on an estimated capture
ESTIMATED_READINGS = [0]


def profiled_ms(fn, iters, dropped):
    """(ms, estimated): mean milliseconds per call that the card spends in
    the kernels `fn` launches, the sum of their durations in one
    torch.profiler capture over `iters` calls.

    As a process goes on, a capture loses more of its first events: 5 or 6
    after the first capture that also records the host, 22 after the second,
    of 50, 200 and 3,450 alike and however long the capture idles before its
    first launch. Summed and divided by `iters`, such a capture reads as a
    faster kernel. So the capture first launches `PROFILE_LEAD` small
    kernels that may be lost, idles `PROFILE_PAD_S`, makes the calls, idles
    again and launches `PROFILE_TRAIL` more. The events are split where the
    card idled for half the pad or more: the last group is the trailing
    kernels, the one before it the calls'. A complete group holds a multiple
    of `iters` events; a capture whose group does not is noted in `dropped`
    and run again with twice the idle time, up to six times or until two
    miss the same number of events. Then, if the fullest group kept at
    least three quarters of its events, the result is an estimate, marked
    so: the mean duration of the events kept times the events per call
    (exact where `fn` launches one kernel, as every kernel of the port
    does). Otherwise (None, False)."""
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(32, device="cuda")
    pad, best = PROFILE_PAD_S, []
    for _ in range(6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                lead.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(pad)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
            for _ in range(PROFILE_TRAIL):
                lead.add_(1.0)
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.elapsed_us())
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        groups, last_end = [[]], None
        for start, duration in events:
            if last_end is not None and start - last_end > pad * 1e6 / 2:
                groups.append([])
            groups[-1].append(duration)
            last_end = start + duration
        durations = groups[-2] if len(groups) >= 2 else []
        if (durations and len(durations) % iters == 0
                and len(groups[-1]) == PROFILE_TRAIL):
            return sum(durations) / iters / 1e3, False
        dropped.append({"events": [len(g) for g in groups], "calls": iters,
                        "pad_s": pad})
        same = len(durations) == len(best)
        best = max(best, durations, key=len)
        if same:
            break
        pad *= 2
    per_call = -(-len(best) // iters)
    if not best or len(best) < 0.75 * per_call * iters:
        return None, False
    dropped[-1]["estimate_from_events"] = len(best)
    return sum(best) / len(best) * per_call / 1e3, True


def kernel_ms(fn, iters=50):
    """`profiled_ms` of `fn`, from two captures that agree: now and then a
    whole capture's durations come out scaled (a kernel at half its time, or
    1.45x, in one capture of some fifteen), so captures are run until two
    lie within 5 % of each other, and their mean is returned. A reading that
    took more than two captures, or an incomplete one, prints them all in a
    `kernel_ms_captures` line (None: a capture `profiled_ms` gave up on),
    and one that rests on an estimated capture adds one to
    `ESTIMATED_READINGS`, which the timing phases print beside their times.
    When eight captures hold no such pair the measurement fails, and the
    phase with it."""
    fn()
    seen, dropped = [], []
    for _ in range(8):
        t, estimated = profiled_ms(fn, iters, dropped)
        pair = next(((u, e) for u, e in seen if None not in (t, u)
                     and abs(t - u) <= 0.05 * max(t, u)), None)
        seen.append((t, estimated))
        if pair is not None:
            estimated = estimated or pair[1]
            ESTIMATED_READINGS[0] += estimated
            if len(seen) > 2 or dropped:
                phase("kernel_ms_captures", captures=[u for u, _ in seen],
                      used=[pair[0], t], estimated=estimated,
                      incomplete=dropped)
            return (pair[0] + t) / 2
    raise AssertionError(f"kernel_ms: no two of eight captures agree: {seen}; "
                         f"incomplete captures: {dropped}")


def device_kernels(fn, calls=10):
    """The kernels the card ran for `fn`, as torch.profiler names them
    (template arguments kept, argument lists cut), so a timing line shows
    which of a wrapper's kernels its shape took. As `profiled_ms` does, the
    capture first launches `PROFILE_LEAD` small kernels that the profiler
    may lose, idles, then makes `calls` calls: the names are those of the
    group of events after the idle gap."""
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(32, device="cuda")
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                lead.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.elapsed_us(),
                         e.name) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        names, last_end = set(), None
        for start, duration, name in events:
            if last_end is not None and start - last_end > PROFILE_PAD_S * 5e5:
                names = set()
            names.add(kernel_name(name))
            last_end = start + duration
        if names:
            return sorted(names)
    raise AssertionError("device_kernels: no capture held the calls")


def kernel_name(name):
    """A kernel's name as torch.profiler gives it, with template arguments
    kept and the return type, anonymous namespace and argument list cut."""
    return name.removeprefix("void ").replace(
        "(anonymous namespace)::", "").split("(")[0]


def traced_events(fn):
    """(kernel name (`kernel_name`), device us) of every kernel the card
    ran in `fn()`, from one torch.profiler capture, kernels replayed from a
    CUDA graph included. As in `profiled_ms`, `PROFILE_LEAD` small kernels,
    which the profiler may lose, go first, and `PROFILE_TRAIL` follow; they
    are listed too, as `add` kernels."""
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            lead.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        for _ in range(PROFILE_TRAIL):
            lead.add_(1.0)
        torch.cuda.synchronize()
    return [(kernel_name(e.name), e.time_range.elapsed_us())
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def traced_kernels(fn):
    """Kernel name -> the times the card ran it in `fn()`
    (`traced_events`)."""
    counts = {}
    for name, _ in traced_events(fn):
        counts[name] = counts.get(name, 0) + 1
    return counts


# the wrappers whose launches a replayed epoch is checked against
WRAPPERS = ("spmm_ell", "spmm_bucketed", "gather_rows")


def wrapper_kernels(counts):
    """K1's, K3's and the row gather's kernels among `traced_kernels`'
    counts, by wrapper (`WRAPPERS`): each launch of a wrapper runs one
    kernel whose name starts with the wrapper's."""
    return {w: sum(n for k, n in counts.items() if k.startswith(w))
            for w in WRAPPERS}


def _step_capture(run, steps):
    """One torch.profiler capture of `run(2, 2 + steps)`: (device ms per
    step, kernels per step, kernel name -> device ms per step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        run(2, 2 + steps)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    events = prof.events()
    host = {e.name for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in host]
    assert kernels, "the profiler saw no kernel on the card"
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return (sum(by_name.values()) / steps / 1e3, len(kernels) / steps,
            {k: v / steps / 1e3 for k, v in by_name.items()})


def step_profile(run, steps=10):
    """Kernels per step, device ms per step and the heaviest kernels of
    `run(2, 2 + steps)` (steps or epochs 2 to 2 + `steps` of a loop, after
    `run(0, 2)` untraced), from torch.profiler captures. As `kernel_ms`
    does, captures are taken until two agree within 5 % on the device ms
    (at most eight; the measurement fails without such a pair): the
    profiler now and then loses a capture's first events or rescales a
    whole capture. The pair's means are returned, with every capture's
    device ms under `captures`. Annotation ranges the trace shows on the
    card (e.g. `Optimizer.step#Adam.step`) overlap real kernels: device
    events whose name is also a host event's are dropped."""
    run(0, 2)
    seen = []
    for _ in range(8):
        got = _step_capture(run, steps)
        pair = next((u for u in seen
                     if abs(got[0] - u[0]) <= 0.05 * max(got[0], u[0])), None)
        seen.append(got)
        if pair is not None:
            names = set(pair[2]) | set(got[2])
            ms = {k: (pair[2].get(k, 0.0) + got[2].get(k, 0.0)) / 2
                  for k in names}
            top = sorted(ms.items(), key=lambda kv: -kv[1])[:8]
            return {"kernels_per_step": (pair[1] + got[1]) / 2,
                    "device_ms_per_step": (pair[0] + got[0]) / 2,
                    "captures": [u[0] for u in seen],
                    "top_ms_per_step": [[k[:100], v] for k, v in top]}
    raise AssertionError("step_profile: no two of eight captures agree: "
                         f"{[u[0] for u in seen]}")


def busy_shares(profiles, rate):
    """Share of an untraced step the card is busy, for two paths `a`, `b`
    (the keys of `profiles`) run in turns a, b, b, a at `rate` steps/s:
    device ms per step times steps/s."""
    (a, pa), (b, pb) = profiles.items()
    return {a: pa["device_ms_per_step"] * (rate[0] + rate[3]) / 2 / 1e3,
            b: pb["device_ms_per_step"] * (rate[1] + rate[2]) / 2 / 1e3}


def check(name, got, ref, tol):
    """Assert `got` close to `ref` within `tol`; return the max abs error."""
    if got.is_cuda:
        torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    assert torch.isfinite(got).all(), name
    torch.testing.assert_close(got.float(), ref.float(), **tol, msg=name)
    return float((got.float() - ref.float()).abs().max()) if got.numel() else 0.0


def _host_bits(v):
    """`v` as a host numpy array (tensors copied), for a bitwise compare."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def repeat_phase(name, run, read, first=None, seconds=None, **info):
    """A repeat phase: `run()` twice in this process, from the same seed
    and inputs; `read(result)` gives {name: what the gate reads} (arrays,
    tensors or numbers), and each must agree bit for bit between the two
    runs: dtype, shape and bytes. `first`: the result of a run an earlier
    phase made, from the same seed and inputs, in place of the first run.
    Prints the phase with `bitwise_equal: true` and the seconds of the runs
    it made (`seconds`: of two runs that rank processes made, which `first`
    and `run` hand over); any difference raises. Returns the first run's
    readings."""
    t0 = time.perf_counter()
    first = read(run() if first is None else first)
    second = read(run())
    if seconds is None:
        seconds = time.perf_counter() - t0
    assert first.keys() == second.keys(), name
    for key in first:
        a, b = _host_bits(first[key]), _host_bits(second[key])
        assert a.dtype == b.dtype and a.shape == b.shape, (name, key)
        assert a.tobytes() == b.tobytes(), (
            name, key, float(np.abs(a.astype(np.float64)
                                    - b.astype(np.float64)).max()))
    phase(name, bitwise_equal=True, compared=sorted(first), seconds=seconds,
          **info)
    return first


@contextlib.contextmanager
def recording(module, name):
    """Record what `module.name` returns while the block runs (every call,
    in order), the function itself unchanged: how a repeat phase reads the
    losses of an entry point that returns only their summary."""
    fn = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append(out)
        return out

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def time_in_turns(plain, kernel):
    """Device ms per call (profiler kernel sums) and host-issued ms per call
    (CUDA events) of `plain` and `kernel`, run in turns plain, kernel,
    kernel, plain so both see the same warm card. `estimated_readings`
    counts the device times that rest on an estimated capture (see
    `kernel_ms`)."""
    before = ESTIMATED_READINGS[0]
    dev_ms = [kernel_ms(f) for f in (plain, kernel, kernel, plain)]
    call_ms = [cuda_ms(f) for f in (plain, kernel, kernel, plain)]
    return {"ms": (dev_ms[1] + dev_ms[2]) / 2,
            "plain_ms": (dev_ms[0] + dev_ms[3]) / 2,
            "estimated_readings": ESTIMATED_READINGS[0] - before,
            "device_ms_plain_kernel_kernel_plain": dev_ms,
            "per_call_ms_plain_kernel_kernel_plain": call_ms}


# ---------------------------------------------------------------------------
# bounds: the bytes a kernel must move and the operations it must do
# ---------------------------------------------------------------------------

# one H100 SXM (NVIDIA's data sheet): device memory rate, and the f32 rate
# outside the tensor cores (all three kernels multiply-add in f32 registers)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def _live_slots(nbr, w, nx):
    """The slots that contribute: weight not 0 and index inside [0, nx)."""
    return (w != 0) & (nbr >= 0) & (nbr < nx)


def spmm_ell_work(nbr, w, x):
    """(bytes, flops) of K1 on these operands: each row of `x` that a live
    slot names read once, the live slots' index and weight read once, the
    f32 output written once; 2 flops per gathered element."""
    nx, f = x.shape
    live = _live_slots(nbr, w, nx)
    n_live = int(live.sum())
    rows = int(torch.unique(nbr[live]).numel())
    return (rows * f * x.element_size()
            + n_live * (nbr.element_size() + w.element_size())
            + nbr.shape[0] * f * 4), 2 * n_live * f


def spmm_bucketed_work(x, inv_perm, bucket_shapes, nbr, w, order=None):
    """(bytes, flops) of K3 on these operands: as K1, plus `inv_perm`; the
    output has `x`'s type. `bucket_shapes` and the launch order move no
    bytes that the function needs."""
    nx, f = x.shape
    live = _live_slots(nbr, w, nx)
    n_live = int(live.sum())
    rows = int(torch.unique(nbr[live]).numel())
    n = inv_perm.shape[0]
    return (rows * f * x.element_size()
            + n_live * (nbr.element_size() + w.element_size())
            + n * inv_perm.element_size()
            + n * f * x.element_size()), 2 * n_live * f


def sddmm_work(src, dst, x, y):
    """(bytes, flops) of K2 on these operands: each row of `x` and of `y`
    that a pair inside both tables names read once (once in all when `x`
    and `y` are one tensor), both index arrays read and the f32 output
    written once; 2 flops per multiplied pair of elements."""
    f = x.shape[1]
    keep = (src >= 0) & (src < x.shape[0]) & (dst >= 0) & (dst < y.shape[0])
    if x.data_ptr() == y.data_ptr() and x.shape == y.shape:
        rows = int(torch.unique(torch.cat([src[keep], dst[keep]])).numel())
    else:
        rows = int(torch.unique(src[keep]).numel()
                   + torch.unique(dst[keep]).numel())
    e = src.shape[0]
    return (rows * f * x.element_size()
            + e * (src.element_size() + dst.element_size()) + e * 4
            ), 2 * int(keep.sum()) * f


def sddmm_grad_work(g, src, dst, x, y=None):
    """(bytes, flops) of K2's gradient on these operands: the outputs (dx
    and dy, or one dh when `y` is None) written once, zeros included; each
    row that a pair inside both tables names read once from the table the
    gradient reads it from; the incidence order, both index arrays and `g`
    read once; 2 flops per gathered element."""
    table = x if y is None else y
    f, es = x.shape[1], x.element_size()
    keep = ((src >= 0) & (src < x.shape[0]) & (dst >= 0)
            & (dst < table.shape[0]))
    if y is None:
        rows = int(torch.unique(torch.cat([src[keep], dst[keep]])).numel())
        out_rows = x.shape[0]
    else:
        rows = int(torch.unique(src[keep]).numel()
                   + torch.unique(dst[keep]).numel())
        out_rows = x.shape[0] + y.shape[0]
    e = src.shape[0]
    return (out_rows * f * es + rows * f * es + 2 * e * 4
            + e * (src.element_size() + dst.element_size() + 4)
            ), 2 * 2 * int(keep.sum()) * f


def atomic_gradient(g, src, dst, x, y=None):
    """K2's plain gradient as the builds before this one summed it: the f32
    terms added by `index_add_`, whose atomics add a row's terms in another
    order on every run, then a cast to the tables' type. `(dx, dy)`, or
    `(dx + dy, None)` with one table. What phase (i) holds beside the
    kernel against the float64 plain version; no path of the port runs
    it."""
    table = x if y is None else y
    keep = ((src >= 0) & (src < x.shape[0]) & (dst >= 0)
            & (dst < table.shape[0]))
    s = torch.where(keep, src, 0).long()
    d = torch.where(keep, dst, 0).long()
    gk = g.float()[:, None]
    terms = [(s, torch.where(keep[:, None], gk * table.index_select(0, d)
                             .float(), 0.0)),
             (d, torch.where(keep[:, None], gk * x.index_select(0, s)
                             .float(), 0.0))]
    if y is None:
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        out.index_add_(0, torch.cat([terms[0][0], terms[1][0]]),
                       torch.cat([terms[0][1], terms[1][1]]))
        return out.to(x.dtype), None
    return tuple(
        torch.zeros(t.shape, dtype=torch.float32, device=x.device)
        .index_add_(0, *term).to(t.dtype) for t, term in zip((x, y), terms))


def parent_gradient(g, src, dst, h):
    """K2's one-table gradient as the build before K2's gradient kernel took
    it: the plain gradient of two tables (`atomic_gradient`), then
    autograd's add of the two. Timed beside the kernel and behind the
    parent's scoring in phase (k)'s profile; no path of the port runs
    it."""
    dx, dy = atomic_gradient(g, src, dst, h, h)
    return dx + dy


class ParentSddmm(torch.autograd.Function):
    """K2 forward with `parent_gradient` behind it: the parent build's
    scoring, for phase (k)'s profile."""

    @staticmethod
    def forward(ctx, src, dst, x):
        from linkpred_tpu_torch.ops import hopper_kernels as hk

        ctx.save_for_backward(src, dst, x)
        return hk.sddmm(src, dst, x, x)

    @staticmethod
    def backward(ctx, g):
        src, dst, x = ctx.saved_tensors
        return None, None, parent_gradient(g, src, dst, x)


def bound(work):
    """The least time the card could take for `work` = (bytes, flops): the
    larger of bytes over its memory rate and flops over its f32 rate."""
    nbytes, flops = work
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


# ---------------------------------------------------------------------------
# library yardsticks: one PyTorch call for the same function. Timed here and
# used nowhere in the port.
# ---------------------------------------------------------------------------


def _csr(rows, cols, vals, shape, dtype=None):
    """CSR matrix of the given entries, duplicates summed in `vals`' type
    and then, where `dtype` is given, rounded to it."""
    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                  vals, shape).coalesce()
    if dtype is not None:
        coo = torch.sparse_coo_tensor(coo.indices(), coo.values().to(dtype),
                                      shape, is_coalesced=True)
    return coo.to_sparse_csr()


def ell_csr(nbr, w, nx):
    """K1's operands as a CSR matrix `[M, nx]`: `spmm_ell(nbr, w, x)` is
    `torch.sparse.mm(ell_csr(nbr, w, nx), x)`."""
    live = _live_slots(nbr, w, nx)
    rows = torch.arange(nbr.shape[0], device=nbr.device)[:, None].expand_as(
        nbr)
    return _csr(rows[live], nbr[live], w[live], (nbr.shape[0], nx))


def bucketed_csr(inv_perm, bucket_shapes, nbr, w, nx, dtype=torch.float32):
    """K3's operands as a CSR matrix `[N, nx]` with the rows in output
    order, so `inv_perm` is absorbed: `spmm_bucketed(x, ...)` is
    `torch.sparse.mm(bucketed_csr(...), x)`. Values in `dtype`."""
    dev = nbr.device
    widths = torch.tensor([wd for r, wd in bucket_shapes for _ in range(r)]
                          + [0], dtype=torch.long, device=dev)
    starts = torch.cumsum(widths, 0) - widths  # first slot of a concat row
    p = inv_perm.long().clamp(0, widths.shape[0] - 1)
    counts = widths[p]
    rows = torch.repeat_interleave(
        torch.arange(p.shape[0], device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    slot = (torch.repeat_interleave(starts[p] - first, counts)
            + torch.arange(int(counts.sum()), device=dev))
    live = _live_slots(nbr, w, nx)[slot]
    return _csr(rows[live], nbr[slot][live], w[slot][live].to(dtype),
                (p.shape[0], nx))


def sddmm_grad_csr(g, src, dst, n, dtype=torch.float32):
    """The pairs as a CSR matrix `[n, n]` weighted by the cotangent at both
    ends (entries (src[e], dst[e]) and (dst[e], src[e]) of g[e], repeated
    pairs summed in f32, then rounded to `dtype`; pairs outside [0, n)
    left out): K2's one-table gradient `sddmm_grad(g, src, dst, h)[0]` is
    `torch.sparse.mm(sddmm_grad_csr(g, src, dst, n), h)`."""
    keep = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    s, d, gk = src[keep], dst[keep], g[keep].float()
    return _csr(torch.cat([s, d]), torch.cat([d, s]), torch.cat([gk, gk]),
                (n, n), dtype)


# a library call against the kernel: the library sums in its own order and,
# in bf16, its own precision (it was seen to differ from the f32 sums by a
# few bf16 ulps), so this only shows that both compute the same function
LIBRARY_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
               torch.bfloat16: dict(rtol=2**-5, atol=2**-5)}


def library_spmm(csr_fn, x, expect):
    """`torch.sparse.mm` of the CSR matrix `csr_fn()` (built once, outside
    the timed call) with `x`, held against `expect` within `LIBRARY_TOL`
    of the largest |expect|. Returns (callable, None), or (None, reason)
    when the call does not take the input."""
    try:
        a = csr_fn()
        got = torch.sparse.mm(a, x)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"no such call: {type(e).__name__}: {str(e)[:300]}"
    scale = max(float(expect.float().abs().max()), 1.0)
    tol = LIBRARY_TOL[x.dtype]
    torch.testing.assert_close(got.float(), expect.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)
    return (lambda: torch.sparse.mm(a, x)), None


def library_sddmm(src, dst, x, y, expect):
    """`torch.sparse.sampled_addmm` (beta 0) over the pairs' pattern, as
    `library_spmm`. The pattern is a CSR matrix, which holds a pair once."""
    key = src.long() * y.shape[0] + dst.long()
    if torch.unique(key).numel() != key.numel():
        return None, ("no such call: the pairs repeat, and a CSR pattern "
                      "holds each (src, dst) once")
    try:
        order = torch.argsort(key)
        pattern = _csr(src, dst, torch.zeros(src.shape, dtype=x.dtype,
                                             device=x.device),
                       (x.shape[0], y.shape[0]))
        yt = y.t()
        got = torch.sparse.sampled_addmm(pattern, x, yt, beta=0.0)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"no such call: {type(e).__name__}: {str(e)[:300]}"
    torch.testing.assert_close(got.values().float(), expect[order],
                               rtol=2**-7, atol=1e-2)
    return (lambda: torch.sparse.sampled_addmm(pattern, x, yt, beta=0.0)), None


def report(times, work, hk, dev, library=None, reason=None, **launch_rate):
    """A timing phase's fields: the kernel's and the plain version's times,
    the bound of `work` and the share of it reached, the floor (an empty
    `<<<1, 32>>>` launch timed the same way; a bound below it cannot be
    reached), the library call's time in two turns or why there is none,
    and the kernel's launches per epoch or step on its path. Where there is
    a library call, `kernel_ms < library_ms` says whether the kernel beat
    it."""
    out = {**times, **bound(work), **launch_rate}
    before = ESTIMATED_READINGS[0]
    out["floor_ms"] = kernel_ms(lambda: hk.empty_launch(dev))
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    if library is None:
        out["library_ms"], out["library"] = None, reason
    else:
        turns = [kernel_ms(library) for _ in range(2)]
        out["library_ms"], out["library_ms_turns"] = sum(turns) / 2, turns
        out["kernel_ms < library_ms"] = out["ms"] < out["library_ms"]
    out["estimated_readings"] += ESTIMATED_READINGS[0] - before
    return out


def in_turns(fns):
    """Device ms per call of each of `fns` (name -> callable, None left
    out), measured in the order given and then in reverse, so each sees
    the card as warm as the others: name -> [first turn, second turn], and
    under `estimated_readings` how many of them rest on an estimated
    capture (see `kernel_ms`)."""
    fns = {k: f for k, f in fns.items() if f is not None}
    turns = {k: [] for k in fns}
    before = ESTIMATED_READINGS[0]
    for name in [*fns, *reversed(fns)]:
        turns[name].append(kernel_ms(fns[name], iters=30))
    turns["estimated_readings"] = ESTIMATED_READINGS[0] - before
    return turns


def launch_rates(run, hk):
    """Kernel launches by kernel and feature width that `run(n)` (a
    training run of `n` epochs or steps) adds per epoch or step: the
    wrappers' counts (`LAUNCHES_BY_WIDTH`) over `run(3)` less those over
    `run(2)`, so what a run does once (building, scoring the test split)
    cancels. The counts are the host's launches: for a loop that replays
    its epoch from a CUDA graph see `graph_launch_rates`."""
    def counted(n):
        hk.LAUNCHES_BY_WIDTH.clear()
        run(n)
        return dict(hk.LAUNCHES_BY_WIDTH)

    two, three = counted(2), counted(3)
    return {k: v - two.get(k, 0) for k, v in three.items()
            if v - two.get(k, 0)}


def single_trial_loop(dev, data, cfg, run, epochs):
    """`loop(a, b)`: epochs a..b of fb-pages-food's single-trial loop
    (`train_loop`, one CUDA graph an epoch after the first) from one
    init, over a schedule of `epochs`."""
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp

    pos_e, neg_e = (torch.as_tensor(a, dtype=torch.long, device=dev)
                    for a in tp.batch_schedule(
                        data, dataclasses.replace(run, epochs=epochs)))
    inputs = (m.SplitArrays.from_split(data.train, dev),
              m.SplitArrays.from_split(data.val, dev),
              torch.as_tensor(data.val.y, device=dev),
              tp.node_features(cfg, data, dev))
    p = m.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = m.adam(p, cfg.learning_rate)
    gen = torch.Generator(device=dev).manual_seed(1)
    # the best carried from call to call, as a run cut into calls does: a
    # fresh best each call would be a new address, and a new capture
    best = (m.tree_map(lambda t: t.detach().clone(), p), 0.0)

    def loop(a, b):
        m.train_loop(p, opt, gen, pos_e[a:b], neg_e[a:b], *inputs, cfg,
                     data.num_nodes, init_best=best)

    return loop


def graph_launch_rates(dev, hk, data, cfg, run, replays=10):
    """`launch_rates` of the single-trial loop (`train_loop`), which
    replays its epoch from a CUDA graph, so the wrappers count an epoch's
    launches once, at the capture: the counts over the call that captures
    (its epoch recorded once, then replayed), with the K1 and K3 kernels
    that a device trace of `replays` replayed epochs shows per epoch, which
    must be as many. Returns (launches by kernel and width, device kernels
    per replayed epoch by wrapper)."""
    from linkpred_tpu_torch.models import twowl as m

    loop = single_trial_loop(dev, data, cfg, run, 2 + replays)

    def counted(fn):
        launches, epochs = dict(hk.LAUNCHES_BY_WIDTH), dict(m.EPOCH_COUNTS)
        fn()
        return ({k: v - launches.get(k, 0)
                 for k, v in hk.LAUNCHES_BY_WIDTH.items()
                 if v - launches.get(k, 0)},
                {k: v - epochs[k] for k, v in m.EPOCH_COUNTS.items()})

    loop(0, 1)  # the optimizer's first epoch, op by op
    rates, epochs = counted(lambda: loop(1, 2))
    assert epochs == {"eager": 0, "replayed": 1, "captures": 1}, epochs
    per_wrapper = {w: sum(v for k, v in rates.items()
                          if k.startswith(w + " "))
                   for w in WRAPPERS}
    readings = []
    for _ in range(3):  # a capture may lose events: at most three
        ran = {}
        host, epochs = counted(lambda: ran.update(
            traced_kernels(lambda: loop(2, 2 + replays))))
        assert not host and epochs == {
            "eager": 0, "replayed": replays, "captures": 0}, (host, epochs)
        readings.append({w: n / replays
                         for w, n in wrapper_kernels(ran).items()})
        if readings[-1] == per_wrapper:
            return rates, readings[-1]
    raise AssertionError(f"replayed epochs ran {readings} K1/K3/gather kernels, "
                         f"the capture recorded {per_wrapper}")


def gcn_phases(dev, hk):
    """(g)-(l): the GCN slice at the full published config (235k nodes, emb
    64, hidden 128, bf16, batch 8,192, 60 steps, lr 3e-3: the config of the
    reference's `bench.py:gate_collab_e2e`). Returns the main path's launch
    counts and K3's and K2's errors and times for the kernels line."""
    from linkpred_tpu_torch import cli
    from linkpred_tpu_torch.ops import sddmm as sd
    from linkpred_tpu_torch.ops import spmm
    from linkpred_tpu_torch.pipelines import gcn_scale as gs

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = gs.ScaleGCNConfig(steps=60, learning_rate=3e-3)
    N = cfg.nodes

    # (g) the seed-0 problem and its bucketed layout on the card
    t0 = time.perf_counter()
    problem = gs.build_problem(cfg)
    g, train_pos, test_pos, test_neg = problem
    lay = spmm.BucketedEll.from_graph(g)
    ops = lay.operands(dev)
    phase("g_gcn_data", nodes=N, directed_edges=g.num_edges,
          buckets=[list(nb.shape) for _, nb, _ in lay.buckets],
          slots=lay.num_slots, train_pos=len(train_pos),
          test_pos=len(test_pos), test_neg=len(test_neg),
          build_seconds=time.perf_counter() - t0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def feats(rows, f, dtype):
        return torch.randn((rows, f), generator=gen, device=dev).to(dtype)

    # (h) K3 against spmm_bucketed_reference: the slice layout at the
    # widths of both layers, ragged F, and two small layouts
    ring = np.stack([(np.arange(50) - 1) % 50, (np.arange(50) + 1) % 50], 1)
    small = {
        "no edges": spmm.BucketedEll.build(np.zeros((9, 1), np.int32),
                                           np.zeros((9, 1), bool)),
        "one bucket": spmm.BucketedEll.build(
            ring.astype(np.int32), np.ones((50, 2), bool),
            np.full((50, 2), 0.5, np.float32)),
    }
    cases = {
        "slice x64 bf16": (feats(N, 64, bf16), ops, BF16_TOL),
        "slice x128 bf16": (feats(N, 128, bf16), ops, BF16_TOL),
        "slice x64 f32": (feats(N, 64, f32), ops, F32_TOL),
        "slice x128 f32": (feats(N, 128, f32), ops, F32_TOL),
        "slice x33 bf16": (feats(N, 33, bf16), ops, BF16_TOL),
        "slice x1 f32": (feats(N, 1, f32), ops, F32_TOL),
        "no edges x7 bf16": (feats(9, 7, bf16), small["no edges"].operands(dev),
                             BF16_TOL),
        "one bucket x7 f32": (feats(50, 7, f32),
                              small["one bucket"].operands(dev), F32_TOL),
    }
    k3_err = 0.0
    for name, (x, ops_, tol) in cases.items():
        before = hk.LAUNCHES["spmm_bucketed"]
        got = hk.spmm_bucketed(x, *ops_)
        assert hk.LAUNCHES["spmm_bucketed"] == before + 1, name
        err = check(name, got, hk.spmm_bucketed_reference(x, *ops_), tol)
        k3_err = max(k3_err, err)
        phase("h_k3_check", case=name, x=list(x.shape), max_abs_err=err)
    for dtype, tol in ((bf16, BF16_TOL), (f32, F32_TOL)):
        x, t = feats(N, 128, dtype), feats(N, 128, dtype)
        grads = []
        for sym in (spmm.spmm_bucketed_sym, spmm.spmm_bucketed_sym_reference):
            xx = x.clone().requires_grad_()
            (sym(xx, N, ops).float() * t.float()).sum().backward()
            grads.append(xx.grad)
        err = check(f"backward x128 {dtype}", grads[0], grads[1], tol)
        k3_err = max(k3_err, err)
        phase("h_k3_backward", x=list(x.shape), dtype=str(dtype),
              max_abs_err=err)
    # the launches one training step adds, by kernel and width
    batches = torch.from_numpy(gs.batch_schedule(cfg, train_pos)).to(dev)

    def steps(n):
        params = gs.init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                                dev)
        gs.train_steps(params, gs.adam(params, cfg.learning_rate),
                       batches[:n], ops, cfg, spmm.spmm_bucketed_sym,
                       sd.sddmm_coo)

    rates = launch_rates(steps, hk)
    phase("g_gcn_launch_rates", launches_per_step=rates)
    k3_time = {}
    for f in (64, 128):
        x = feats(N, f, bf16)
        expect = hk.spmm_bucketed(x, *ops)
        library, reason = library_spmm(
            lambda: bucketed_csr(*ops, N, dtype=bf16), x, expect)
        k3_time[f] = report(
            time_in_turns(lambda: hk.spmm_bucketed_reference(x, *ops),
                          lambda: hk.spmm_bucketed(x, *ops)),
            spmm_bucketed_work(x, *ops), hk, dev, library, reason,
            launches_per_step=rates.get(f"spmm_bucketed F={f}", 0))
        phase("h_k3_time", case=f"slice x{f} bf16", **k3_time[f],
              device_kernel=device_kernels(lambda: hk.spmm_bucketed(x, *ops)))

    # (i) K2 against sddmm_reference: a training step's 2 x 8,192 pairs and
    # the 51,200 test pairs at F = 128, then ragged cases
    both = np.concatenate([test_pos, test_neg]).astype(np.int32)
    test_pairs = torch.from_numpy(np.ascontiguousarray(both.T)).to(dev)
    h_bf, h_32 = feats(N, 128, bf16), feats(N, 128, f32)

    def rand_pairs(e, lo=-1, hi=N + 1):
        return [torch.randint(lo, hi, (e,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(2)]

    # a hub: node 7 named by 500 of the pairs, at both ends
    hub = [torch.where(torch.arange(16384, device=dev) % 33 == k,
                       torch.full_like(p, 7), p)
           for k, p in enumerate(rand_pairs(16384, 0, N))]
    cases = {
        "step 16384 x128 bf16": (*batches[0], h_bf, h_bf),
        "step 16384 x128 f32": (*batches[0], h_32, h_32),
        "test 51200 x128 bf16": (*test_pairs, h_bf, h_bf),
        "hub 16384 x128 bf16": (*hub, h_bf, feats(N, 128, bf16)),
        "unaligned 16384 x128 bf16": (*batches[0], offset_copy(h_bf),
                                      offset_copy(h_bf)),
        "ragged 16384 x33 bf16": (*rand_pairs(16384), feats(N, 33, bf16),
                                  feats(N, 33, bf16)),
        "ragged 16384 x1 f32": (*rand_pairs(16384), feats(N, 1, f32),
                                feats(N, 1, f32)),
        "one edge x128 f32": (*rand_pairs(1, 0, N), h_32, feats(N, 128, f32)),
    }
    k2_err = 0.0
    for name, args in cases.items():
        before = hk.LAUNCHES["sddmm"]
        got = hk.sddmm(*args)
        assert hk.LAUNCHES["sddmm"] == before + 1, name
        err = check(name, got, hk.sddmm_reference(*args), K2_TOL)
        k2_err = max(k2_err, err)
        phase("i_k2_check", case=name, max_abs_err=err)
    step_args = cases["step 16384 x128 bf16"]
    library, reason = library_sddmm(*step_args, hk.sddmm(*step_args))
    k2_time = report(
        time_in_turns(lambda: hk.sddmm_reference(*step_args),
                      lambda: hk.sddmm(*step_args)),
        sddmm_work(*step_args), hk, dev, library, reason,
        launches_per_step=rates.get("sddmm F=128", 0))
    phase("i_k2_time", case="step 16384 x128 bf16", **k2_time,
          device_kernel=device_kernels(lambda: hk.sddmm(*step_args)))
    # K2's gradient against its plain version: one table (the GCN's case),
    # two tables, the hub, pairs outside the tables, rows that are not
    # 16-byte groups; each launched twice and bitwise equal
    gen_g = torch.Generator(device=dev).manual_seed(3)

    def cot(e):
        return torch.randn(e, generator=gen_g, device=dev)

    grad_cases = {
        "step one table x128 bf16": (*batches[0], h_bf, None),
        "step one table x128 f32": (*batches[0], h_32, None),
        "step two tables x128 bf16": (*batches[0], h_bf, feats(N, 128, bf16)),
        "hub one table x128 bf16": (*hub, h_bf, None),
        "hub two tables x128 f32": (*hub, h_32, feats(N, 128, f32)),
        "outside one table x64 bf16": (*rand_pairs(16384), feats(N, 64, bf16),
                                       None),
        "ragged two tables x33 bf16": (*rand_pairs(16384), feats(N, 33, bf16),
                                       feats(N, 33, bf16)),
        "test one table x128 bf16": (*test_pairs, h_bf, None),
    }
    k2g_err = 0.0
    for name, (src, dst, x, y) in grad_cases.items():
        g_case = cot(src.shape[0])
        before = hk.LAUNCHES["sddmm_grad"]
        got = hk.sddmm_grad(g_case, src, dst, x, y)
        again = hk.sddmm_grad(g_case, src, dst, x, y)
        assert hk.LAUNCHES["sddmm_grad"] == before + 2, name
        ref = hk.sddmm_grad_reference(g_case, src, dst, x, y)
        tol = BF16_TOL if x.dtype == bf16 else F32_TOL
        err = max(check(f"{name} {k}", a, b, tol) for k, a, b in
                  (("dx", got[0], ref[0]), ("dy", got[1], ref[1]))
                  if a is not None)
        assert all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None), name
        k2g_err = max(k2g_err, err)
        phase("i_k2_grad_check", case=name, max_abs_err=err,
              bitwise_repeatable=True)
    src, dst = batches[0]
    g_step = cot(src.shape[0])
    order = hk.incidence_order(src, dst)
    expect = hk.sddmm_grad(g_step, src, dst, h_bf, None, order)[0]
    library, reason = library_spmm(
        lambda: sddmm_grad_csr(g_step, src, dst, N, bf16), h_bf, expect)
    before = ESTIMATED_READINGS[0]
    k2g_time = report(
        time_in_turns(
            lambda: hk.sddmm_grad_reference(g_step, src, dst, h_bf),
            lambda: hk.sddmm_grad(g_step, src, dst, h_bf, None, order)),
        sddmm_grad_work(g_step, src, dst, h_bf), hk, dev, library, reason,
        launches_per_step=rates.get("sddmm_grad F=128", 0))
    parent = [kernel_ms(lambda: parent_gradient(g_step, src, dst, h_bf))
              for _ in range(2)]
    k2g_time.update(
        parent_ms=sum(parent) / 2, parent_ms_turns=parent,
        with_order_ms=kernel_ms(lambda: hk.sddmm_grad(g_step, src, dst,
                                                      h_bf)),
        order_ms=kernel_ms(lambda: hk.incidence_order(src, dst)),
        zero_fill_ms=kernel_ms(lambda: torch.zeros_like(h_bf)))
    k2g_time["estimated_readings"] = ESTIMATED_READINGS[0] - before
    phase("i_k2_grad_time", case="step one table x128 bf16", **k2g_time,
          device_kernel=device_kernels(
              lambda: hk.sddmm_grad(g_step, src, dst, h_bf, None, order)))
    # (i_k2_grad_exact) the card test's hub runs at E = 16,385 f32 (node
    # n - 1 named by every 33rd src, node 0 by every 33rd dst): the
    # kernel's and the atomic f32 plain version's (six runs) distance from
    # the float64 plain version, at the hub rows and anywhere, and how far
    # each lies beyond the f32 tolerance (the card test holds the kernel)
    n_s, e_s = 20_000, 16_385
    g_s = torch.randn(e_s, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(e_s))
    at = torch.arange(e_s, device=dev)
    for f in (128, 33):
        for two in (False, True):
            gen_s = torch.Generator(device=dev).manual_seed(e_s)
            s_s, d_s = (torch.randint(0, n_s, (e_s,), generator=gen_s,
                                      device=dev, dtype=torch.int32)
                        for _ in range(2))
            s_s = torch.where(at % 33 == 0, n_s - 1, s_s).to(torch.int32)
            d_s = torch.where(at % 33 == 1, 0, d_s).to(torch.int32)
            x_s = torch.randn((n_s, f), device=dev, generator=torch.Generator(
                device=dev).manual_seed(3))
            y_s = torch.randn((n_s, f), device=dev, generator=torch.Generator(
                device=dev).manual_seed(4)) if two else None
            exact = [t for t in hk.sddmm_grad_reference(g_s, s_s, d_s, x_s,
                                                        y_s) if t is not None]
            kernel = [t for t in hk.sddmm_grad(g_s, s_s, d_s, x_s, y_s)
                      if t is not None]

            def dist(got):
                worst = max(float((a - b).abs().max())
                            for a, b in zip(got, exact))
                hub = max(float((a[r] - b[r]).abs().max())
                          for a, b in zip(got, exact) for r in (0, n_s - 1))
                # the largest miss beyond the f32 tolerance (<= 0: within)
                over = max(float(((a - b).abs() - F32_TOL["atol"]
                                  - F32_TOL["rtol"] * b.abs()).max())
                           for a, b in zip(got, exact))
                return worst, hub, over

            atomic = [[t for t in atomic_gradient(g_s, s_s, d_s, x_s, y_s)
                       if t is not None] for _ in range(6)]
            k_err = dist(kernel)
            phase("i_k2_grad_exact", e=e_s, f=f,
                  tables="two" if two else "one",
                  kernel_max_abs_err=k_err[0], kernel_hub_max_abs_err=k_err[1],
                  kernel_over_tol=k_err[2],
                  atomic_max_abs_err=[dist(a)[0] for a in atomic],
                  atomic_hub_max_abs_err=[dist(a)[1] for a in atomic],
                  atomic_over_tol=[dist(a)[2] for a in atomic],
                  atomic_runs_bitwise_equal=all(
                      torch.equal(a, b) for run in atomic[1:]
                      for a, b in zip(atomic[0], run)), tol=F32_TOL)

    # (j) the main path: `train_collab` at the full config (GCN_SEEDS).
    # The launch counts are zeroed just before and read just after each run.
    launches = by_width = None
    for seed in GCN_SEEDS:
        for k in hk.LAUNCHES:
            hk.LAUNCHES[k] = 0
        hk.LAUNCHES_BY_WIDTH.clear()
        res = gs.train_collab(dataclasses.replace(cfg, seed=seed), device=dev,
                              verbose=False)
        counts = dict(hk.LAUNCHES)
        if seed == 0:
            launches, by_width = counts, dict(hk.LAUNCHES_BY_WIDTH)
        assert set(res) == GCN_KEYS, sorted(res)
        assert res["loss_decreased"], res
        assert res["test_auc"] >= GCN_AUC_FLOOR, res
        assert all(counts[k] > 0 for k in ("spmm_bucketed", "sddmm",
                                           "sddmm_grad")), counts
        phase("j_gcn_train", seed=seed, launches=counts, **res)

    # (k) the same steps on the kernels and on their plain versions, in
    # turns (kernel, plain, plain, kernel), from the same initial params;
    # then a torch.profiler trace of 10 steps of each
    def plain_score(src, dst, h):
        return hk.sddmm_reference(src, dst, h, h).to(h.dtype)

    paths = {"kernel": (spmm.spmm_bucketed_sym, sd.sddmm_coo),
             "plain": (spmm.spmm_bucketed_sym_reference, plain_score)}
    turns, before = [], dict(hk.LAUNCHES)
    for name in ("kernel", "plain", "plain", "kernel"):
        params = gs.init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                                dev)
        turns.append(gs.train_and_score(cfg, problem, ops, params, dev,
                                        *paths[name]))
    # the kernel runs' launches (the plain runs launch none)
    turn_launches = {k: hk.LAUNCHES[k] - before[k] for k in before}
    assert all(turn_launches[k] > 0 for k in ("spmm_bucketed", "sddmm",
                                              "sddmm_grad")), turn_launches
    rate = [cfg.steps / r["train_seconds"] for r in turns]
    assert turns[1]["loss_decreased"], turns[1]
    assert abs(turns[1]["test_auc"] - turns[0]["test_auc"]) < 0.01, turns
    # the profiles: the kernel path, the plain one, and the parent build's
    # step (K2's gradient in plain PyTorch, `parent_gradient`)
    def parent_score(src, dst, h):
        return ParentSddmm.apply(src, dst, h).to(h.dtype)

    profiles = {}
    for name, (agg, score) in [*paths.items(),
                               ("parent", (spmm.spmm_bucketed_sym,
                                           parent_score))]:
        params = gs.init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                                dev)
        opt = gs.adam(params, cfg.learning_rate)
        profiles[name] = step_profile(
            lambda a, b: gs.train_steps(params, opt, batches[a:b], ops, cfg,
                                        agg, score))
    parent_profile = profiles.pop("parent")
    # the share of a step's device time that K2's gradient takes (on the
    # kernel path with the incidence sort its backward does)
    gradient = {
        "kernel_ms": k2g_time["ms"],
        "kernel_and_sort_ms": k2g_time["with_order_ms"],
        "parent_ms": k2g_time["parent_ms"],
        "kernel_share": k2g_time["with_order_ms"] / profiles["kernel"][
            "device_ms_per_step"],
        "parent_share": k2g_time["parent_ms"] / parent_profile[
            "device_ms_per_step"],
        "device_ms_per_step_kernel_parent": [
            profiles["kernel"]["device_ms_per_step"],
            parent_profile["device_ms_per_step"]],
        "kernels_per_step_kernel_parent": [
            profiles["kernel"]["kernels_per_step"],
            parent_profile["kernels_per_step"]]}
    phase("k_gcn_turns", steps=cfg.steps, gradient=gradient,
          launches_kernel_turns=turn_launches,
          parent_profile=parent_profile,
          steps_per_s=(rate[0] + rate[3]) / 2,
          plain_steps_per_s=(rate[1] + rate[2]) / 2,
          steps_per_s_kernel_plain_plain_kernel=rate,
          test_auc_kernel_plain_plain_kernel=[r["test_auc"] for r in turns],
          loss_last_quarter_kernel_plain=[turns[0]["loss_last_quarter"],
                                          turns[1]["loss_last_quarter"]],
          busy_share=busy_shares(profiles, rate), profile=profiles)

    # two identical runs of the collab training from the same parameters:
    # K2's gradient kernel writes every row once in a fixed order, so the
    # losses and the test AUC repeat bit for bit (the parent's plain
    # gradient added its rows by index_add_'s atomics, and did not)
    runs = []
    for _ in range(2):
        params = gs.init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                                dev)
        res, losses = gs.train_and_score(cfg, problem, ops, params, dev,
                                         spmm.spmm_bucketed_sym, sd.sddmm_coo,
                                         return_losses=True)
        runs.append((losses, res["test_auc"]))
    assert np.array_equal(runs[0][0], runs[1][0]), runs
    assert runs[0][1] == runs[1][1], runs
    phase("k_gcn_repeat", steps=cfg.steps, losses_bitwise_equal=True,
          test_auc=[r[1] for r in runs],
          last_losses=[[float(v) for v in r[0][-3:]] for r in runs])

    # (l) the entry point a user calls, in this process
    out = io.StringIO()
    before = dict(hk.LAUNCHES)
    with contextlib.redirect_stdout(out):
        cli.main(["scale", "--family", "gcn", "--steps", "8"])
    lines = out.getvalue().strip().splitlines()
    res = json.loads(lines[-1])
    assert set(res) == GCN_KEYS, sorted(res)
    assert res["steps"] == 8 and res["nodes"] == N
    assert np.isfinite(res["loss_first_quarter"]) and 0 <= res["test_auc"] <= 1
    assert all(hk.LAUNCHES[k] > before[k] for k in ("spmm_bucketed", "sddmm"))
    phase("l_cli_scale", printed=lines[:-1], **res)

    # (s) the width scan's GCN part: K3 on the slice's layout in bf16
    # against its plain version and the library call, in turns
    for f in (64, 128):
        x = feats(N, f, bf16)
        library, reason = library_spmm(
            lambda: bucketed_csr(*ops, N, dtype=bf16), x,
            hk.spmm_bucketed(x, *ops))
        line = in_turns({
            "kernel": lambda: hk.spmm_bucketed(x, *ops),
            "plain": lambda: hk.spmm_bucketed_reference(x, *ops),
            "library": library})
        line["bound_ms"] = bound(spmm_bucketed_work(x, *ops))["bound_ms"]
        line["device_kernel"] = device_kernels(
            lambda: hk.spmm_bucketed(x, *ops))
        phase("s_k_width_scan", f=f, dtype="bfloat16", layout="gcn slice",
              library=reason, device_ms={"k3": line})

    return {"launches": launches, "by_width": by_width, "k3_err": k3_err,
            "k3_time": k3_time,
            "k2_err": k2_err, "k2_time": k2_time, "k2g_err": k2g_err,
            "k2g_time": k2g_time, "graph": g,
            "problem": problem}


def offset_copy(x):
    """`x` in storage that starts one element past an allocation: the
    allocator hands out blocks on 512-byte boundaries, so this copy's rows
    are not 16-byte aligned and take a kernel's unaligned path."""
    big = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = big[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


def edge_case_operands(k3, x):
    """The K3 operands `k3` and the features `x` bent into the cases a
    kernel must survive: row 0 of `x` is NaN and every slot that names it
    has weight 0 (a pad that points at a NaN row), one output row maps to
    the zero row (degree 0), and an empty bucket sits in the table."""
    inv_perm, shapes, nbr, w, order = k3
    x = x.clone()
    x[0] = float("nan")
    w = torch.where(nbr == 0, 0.0, w)
    inv_perm = inv_perm.clone()
    inv_perm[3] = sum(r for r, _ in shapes)
    shapes = shapes[:1] + ((0, 8),) + shapes[1:]
    return x, (inv_perm, shapes, nbr, w, order)


def sweep_phases(dev, hk, data, run, trn, rates):
    """(m)-(s): the trial-major sweep. Returns the sweep's launch counts and
    K1's and K3's errors and times at its shapes for the kernels line.
    `rates` holds the launches per epoch of the single-trial loop and of
    the sweep, by kernel and width."""
    from linkpred_tpu_torch import cli
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.ops import segment as seg
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp

    T = SWEEP_TRIALS
    # the widths at which the single-trial loop and the sweep launch K1 and
    # K3 (each `rates` key is "<kernel> F=<f>"): phases (m) and (n) hold the
    # kernels against their plain versions at every one of them
    path_widths = {
        k: {int(key.split("F=")[1]) for path in rates.values()
            for key in path if key.startswith(k + " ")}
        for k in ("spmm_ell", "spmm_bucketed")}
    val = m.SplitArrays.from_split(data.val, dev)
    tst = m.SplitArrays.from_split(data.test, dev)
    gen = torch.Generator(device=dev).manual_seed(2)

    def feats(rows, f, dtype=torch.float32):
        return torch.randn((rows, f), generator=gen, device=dev).to(dtype)

    # (m) K3 on the paired 2-WL composed operands (2C = 32 channels per
    # trial) against its plain version and against the plain bucket-sum
    # that 'plan' runs
    R = trn.num_rows
    bf16 = torch.bfloat16
    cases = {
        "train fwd F=32": (trn.e1_cops[0], 32),
        "train bwd F=32": (trn.e1_cops[1], 32),
        "train fwd F=1024": (trn.e1_cops[0], 32 * T),
        "train bwd F=1024": (trn.e1_cops[1], 32 * T),
        "val fwd F=1024": (val.e1_cops[0], 32 * T),
        "test fwd F=1024": (tst.e1_cops[0], 32 * T),
    }
    k3_err = 0.0
    for name, (ops, f) in cases.items():
        x = feats(ops.k3[0].shape[0], f)
        before = hk.LAUNCHES["spmm_bucketed"]
        got = hk.spmm_bucketed(x, *ops.k3)
        assert hk.LAUNCHES["spmm_bucketed"] == before + 1, name
        err = check(name, got, hk.spmm_bucketed_reference(x, *ops.k3),
                    F32_TOL)
        check(name + " vs bucket-sum", got,
              seg._bucket_sum(x, ops.inv_perm, ops.buckets), F32_TOL)
        k3_err = max(k3_err, err)
        phase("m_k3_check", case=name, x=list(x.shape),
              buckets=[list(b) for b in ops.k3[1]],
              slots=int(ops.k3[2].shape[0]), max_abs_err=err)
    # K3's kernels (rows of whole 16-byte groups take the packed kernel up
    # to 256 bytes, one row a warp here, where the card holds all output
    # rows at once, and the wide one above; F = 34 takes the warp-per-row
    # kernel in pairs, F = 1 the slot kernel) at every width the paths
    # launch it at, forward and transpose, also from storage that is offset
    # by one element (the warp-per-row kernel) and on the bent operands of
    # edge_case_operands
    k3_widths = sorted({32, 34, 96, 100, 768, 1024, 1028}
                       | path_widths["spmm_bucketed"])
    assert {1, 32, 32 * T} <= set(k3_widths), path_widths
    for f, dtype, tol in [*((f, torch.float32, F32_TOL) for f in k3_widths),
                          (1024, bf16, BF16_TOL)]:
        errs = {}
        for direction, ops in zip(("fwd", "bwd"), trn.e1_cops):
            x = feats(R, f, dtype)
            ref = hk.spmm_bucketed_reference(x, *ops.k3)
            errs[direction] = check(
                f"{direction} F={f}", hk.spmm_bucketed(x, *ops.k3), ref, tol)
            errs[direction + " no order"] = check(
                f"{direction} F={f} no order",
                hk.spmm_bucketed(x, *ops.k3[:4]), ref, tol)
            errs[direction + " offset"] = check(
                f"{direction} F={f} offset",
                hk.spmm_bucketed(offset_copy(x), *ops.k3), ref, tol)
            xe, k3e = edge_case_operands(ops.k3, x)
            got = hk.spmm_bucketed(xe, *k3e)
            assert not got[3].any(), "the degree-0 row is not zero"
            errs[direction + " edge cases"] = check(
                f"{direction} F={f} edge cases", got,
                hk.spmm_bucketed_reference(xe, *k3e), tol)
        k3_err = max(k3_err, *errs.values())
        phase("m_k3_wide_check", f=f, dtype=str(dtype), max_abs_err=errs)
    x, cot = feats(R, 32 * T).reshape(R, T, 32), feats(R, 32 * T)
    grads = []
    for kernel in (True, False):
        xx = x.clone().requires_grad_()
        seg.gather_sum_composed(xx, *trn.e1_cops, kernel).backward(
            cot.reshape(x.shape))
        grads.append(xx.grad)
    err = check("gather_sum_composed grad", grads[0], grads[1], F32_TOL)
    k3_err = max(k3_err, err)
    phase("m_k3_grad", x=list(x.shape), max_abs_err=err)
    # timed at the single-trial width (slice 1's 2-WL), at T = 32 and at
    # F = 1, the degree pass of both paths (the slot kernel)
    fwd = trn.e1_cops[0]
    k3_times = {}
    for f, paths in ((32, ("slice",)), (32 * T, ("sweep",)),
                     (1, ("slice", "sweep"))):
        x = feats(R, f)
        library, reason = library_spmm(
            lambda: bucketed_csr(*fwd.k3[:4], R), x,
            hk.spmm_bucketed(x, *fwd.k3))
        k3_times[f] = report(
            time_in_turns(lambda: hk.spmm_bucketed_reference(x, *fwd.k3),
                          lambda: hk.spmm_bucketed(x, *fwd.k3)),
            spmm_bucketed_work(x, *fwd.k3), hk, dev, library, reason,
            launches_per_epoch={
                p: rates[p].get(f"spmm_bucketed F={f}", 0) for p in paths})
        phase("m_k3_time", case=f"train fwd F={f}", x=list(x.shape),
              **k3_times[f], device_kernel=device_kernels(
                  lambda: hk.spmm_bucketed(x, *fwd.k3)),
              bucket_sum=time_in_turns(
                  lambda: seg._bucket_sum(x, fwd.inv_perm, fwd.buckets),
                  lambda: hk.spmm_bucketed(x, *fwd.k3)))

    # (n) K1 at the trial-major 1-WL shapes [620, 114] x [3556, 24 T] and
    # [3556, 16 T] and at every other width the paths launch it at, and both
    # of its kernels on ragged, offset and NaN-pad inputs
    S = trn.num_msg
    k1_err = 0.0
    k1_widths = sorted({24, 100, 768, 772} | path_widths["spmm_ell"])
    assert {16, 24, 16 * T, 24 * T} <= set(k1_widths), path_widths
    for f in k1_widths:
        x = feats(S, f)
        args = (trn.msg_slots, trn.msg_sweight, x)
        ref = hk.spmm_ell_reference(*args)
        before = hk.LAUNCHES["spmm_ell"]
        errs = {"x": check(f"K1 F={f}", hk.spmm_ell(*args), ref, F32_TOL)}
        assert hk.LAUNCHES["spmm_ell"] == before + 1
        errs["offset"] = check(
            f"K1 F={f} offset",
            hk.spmm_ell(trn.msg_slots, trn.msg_sweight, offset_copy(x)), ref,
            F32_TOL)
        # random weights and indices, some outside x's rows; row 0 of x is
        # NaN and every slot that names it has weight 0. Up to 87 products
        # of two normal draws, added in another order than the plain
        # version's: atol 5e-5
        nbr = torch.randint(-2, S + 3, (70, 130), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.randn((70, 130), generator=gen, device=dev)
        w[::3] = 0.0
        w[nbr == 0] = 0.0
        xn = x.clone()
        xn[0] = float("nan")
        errs["ragged, NaN pad"] = check(
            f"K1 F={f} ragged", hk.spmm_ell(nbr, w, xn),
            hk.spmm_ell_reference(nbr, w, xn), dict(rtol=1e-5, atol=5e-5))
        k1_err = max(k1_err, *errs.values())
        phase("n_k1_wide_check", f=f, max_abs_err=errs)
    # timed at the sweep's widths, 24 T and 16 T, and at the single trial's
    # F = 16 (its F = 24 is timed in phase (c))
    k1_times = {}
    for f, path in ((24 * T, "sweep"), (16 * T, "sweep"), (16, "slice")):
        args = (trn.msg_slots, trn.msg_sweight, feats(S, f))
        library, reason = library_spmm(lambda: ell_csr(*args[:2], S),
                                       args[2], hk.spmm_ell(*args))
        k1_times[f] = report(
            time_in_turns(lambda: hk.spmm_ell_reference(*args),
                          lambda: hk.spmm_ell(*args)),
            spmm_ell_work(*args), hk, dev, library, reason,
            launches_per_epoch=rates[path].get(f"spmm_ell F={f}", 0))
        phase("n_k1_trials" if f == 24 * T else "n_k1_time",
              shape=[list(a.shape) for a in args], max_abs_err=k1_err,
              **k1_times[f],
              device_kernel=device_kernels(lambda: hk.spmm_ell(*args)))

    # (o) forward_trials at T = 32 against the single-trial forward of each
    # extracted trial (eval mode), and one train_step_trials on 'ell'
    # against 'plan' from the same parameters, dropouts 0, lr 1e-3
    cfg = m.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell")
    params = m.init_params_trials(cfg, T, torch.Generator().manual_seed(0),
                                  dev)
    deg = torch.as_tensor(data.node_deg, dtype=torch.long, device=dev)
    val_sel = val.num_msg + torch.arange(val.num_rows - val.num_msg,
                                         device=dev)
    val_mask = torch.ones(val.num_msg, dtype=torch.bool, device=dev)
    # random-init logits reach ~100 and the f32 sums behind them round at
    # ~1e-5 absolute: atol 1e-5 of the largest |logit|, rtol 1e-5
    with torch.no_grad():
        logits = m.forward_trials(params, cfg, deg, val, val_mask, val_sel)
        tol = dict(rtol=1e-5, atol=1e-5 * float(logits.abs().max()))
        single_err = max(check(f"trial {i}", logits[:, i], m.forward(
            m.extract_trial(params, i), cfg, deg, val, val_mask, val_sel),
            tol) for i in range(T))
    cfg0 = dataclasses.replace(cfg, dp_emb=0.0, dp_1wl0=0.0, dp_1wl1=0.0,
                               dp_2wl=0.0)
    pos, neg = (torch.as_tensor(a[0], dtype=torch.long, device=dev)
                for a in tp.batch_schedule(data, run))
    zeros = torch.zeros(T, device=dev)
    steps = {}
    for agg in ("ell", "plan"):
        p = m.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        losses = m.train_step_trials(
            p, m.adam_trials_init(p), None, pos, neg, trn,
            dataclasses.replace(cfg0, agg_1wl=agg),
            torch.full((T,), 1e-3, device=dev), data.num_nodes,
            m.TrialRates(zeros, zeros, zeros, zeros))
        steps[agg] = (losses, p)
    loss_err = check("step losses", steps["ell"][0], steps["plan"][0],
                     dict(rtol=1e-5, atol=1e-6))
    # a conv bias feeding GraphNorm has an f32-noise gradient, which Adam
    # turns into a step of up to lr: those leaves may differ by 2 lr, and
    # so, at worst, may an entry whose gradient is near 0
    marks = m.tree_map(lambda _: False, params)
    for key in ("conv1", "conv2", "conv2r"):
        for layer in marks[key]:
            layer["b"] = True
    param_err = {True: 0.0, False: 0.0}
    for cancelled, a, b in zip(m.tree_leaves(marks),
                               m.tree_leaves(steps["ell"][1]),
                               m.tree_leaves(steps["plan"][1])):
        param_err[cancelled] = max(param_err[cancelled],
                                   float((a - b).detach().abs().max()))
    assert max(param_err.values()) <= 2e-3 + 1e-6, param_err
    phase("o_forward_trials", trials=T, logits=list(logits.shape),
          max_abs_logit=float(logits.abs().max()),
          max_abs_err_vs_single=single_err, step_loss_max_abs_err=loss_err,
          step_losses_ell=steps["ell"][0].tolist(),
          step_param_max_abs_diff={"gn_cancelled_biases": param_err[True],
                                   "other": param_err[False]})

    # (p) the headline: bench.py's sweep, 32 trials x 1000 epochs at the
    # published-best architecture, data seed 0. Warmed by a short sweep;
    # the launch counts are zeroed just before the run and read just after.
    tp.refine_vmapped(data, cfg, dataclasses.replace(run, epochs=5),
                      n_trials=T, device=dev)
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    hk.LAUNCHES_BY_WIDTH.clear()
    t0 = time.perf_counter()
    res = tp.refine_vmapped(data, cfg,
                            dataclasses.replace(run, epochs=SWEEP_EPOCHS),
                            n_trials=T, device=dev)
    wall = time.perf_counter() - t0
    launches, by_width = dict(hk.LAUNCHES), dict(hk.LAUNCHES_BY_WIDTH)
    assert launches["spmm_ell"] > 0 and launches["spmm_bucketed"] > 0, \
        launches
    assert by_width.get("spmm_bucketed F=1") and by_width.get(
        f"spmm_ell F={16 * T}"), by_width
    assert res["val_aucs"].shape == (T,) and np.isfinite(res["val_aucs"]).all()
    assert res["test_auc"] >= SWEEP_TEST_FLOOR, res["test_auc"]
    assert res["best_val"] >= SWEEP_VAL_FLOOR, res["best_val"]
    phase("p_sweep32", trials=T, epochs=SWEEP_EPOCHS, wall_seconds=wall,
          train_seconds=res["train_seconds"],
          epochs_per_s=SWEEP_EPOCHS / wall,
          trial_epochs_per_s=T * SWEEP_EPOCHS / wall,
          train_epochs_per_s=SWEEP_EPOCHS / res["train_seconds"],
          best_val=res["best_val"], test_auc=res["test_auc"],
          winner=res["winner"], val_aucs=res["val_aucs"].tolist(),
          launches=launches, launches_by_width=by_width)

    # the same sweep at 100 epochs on the kernels and on the plain
    # aggregations, in turns; then a torch.profiler trace of 10 epochs of
    # each after 2 untraced
    run_t = dataclasses.replace(run, epochs=TURN_EPOCHS)
    turns = [tp.refine_vmapped(data, dataclasses.replace(cfg, agg_1wl=agg),
                               run_t, n_trials=T, device=dev)
             for agg in ("ell", "plan", "plan", "ell")]
    rate = [TURN_EPOCHS / r["train_seconds"] for r in turns]
    profiles = {}
    for agg in ("ell", "plan"):
        c = dataclasses.replace(cfg, agg_1wl=agg)
        rng = np.random.default_rng(run.seed + 17)
        lrs, rates_np = tp._sample_trial_configs(rng, T)
        p, opt, g, pos_e, neg_e, inputs = tp._trial_start(
            data, c, run_t, run.seed, T, rng, dev)
        lrs, rates = torch.as_tensor(lrs, device=dev), tp._trial_rates(
            rates_np, dev)

        profiles[agg] = step_profile(
            lambda a, b: m.train_loop_trials(
                p, opt, g, pos_e[a:b], neg_e[a:b], *inputs, c, lrs,
                data.num_nodes, rates))
    phase("p_sweep_turns", trials=T, epochs=TURN_EPOCHS,
          epochs_per_s=(rate[0] + rate[3]) / 2,
          plan_epochs_per_s=(rate[1] + rate[2]) / 2,
          epochs_per_s_ell_plan_plan_ell=rate,
          best_val_ell_plan_plan_ell=[r["best_val"] for r in turns],
          busy_share=busy_shares(profiles, rate), profile=profiles)

    # (p_repeat) the sweep cut to 20 epochs, twice from one seed: every
    # epoch's losses and val AUCs [E, T] (read from the trial loop), the
    # winner and its test AUC
    def sweep_short():
        with recording(m, "train_loop_trials") as loops:
            res = tp.refine_vmapped(
                data, cfg,
                dataclasses.replace(run, epochs=REPEAT_SWEEP_EPOCHS),
                n_trials=T, device=dev)
        return res, loops

    repeat_phase(
        "p_sweep_repeat", sweep_short,
        lambda r: {"losses": r[1][0][2][0], "val_aucs": r[1][0][2][1],
                   "best_val_aucs": r[0]["val_aucs"],
                   "winner": np.array(list(r[0]["winner"].values())),
                   "test_auc": r[0]["test_auc"]},
        trials=T, epochs=REPEAT_SWEEP_EPOCHS)

    # (q) successive halving and the adaptive rounds at reduced size
    run_q = dataclasses.replace(run, epochs=REFINE_EPOCHS)
    before = dict(hk.LAUNCHES)
    res = tp.refine_halving(data, cfg, run_q, n_trials=16, eta=2,
                            min_trials=4, rung_epochs=REFINE_EPOCHS // 4,
                            device=dev)
    assert res["configs_inspected"] == 16 and len(res["survivors"]) == 4, res
    assert res["val_aucs"].shape == (4,)
    assert 0.0 <= res["test_auc"] <= 1.0 and 0.0 <= res["best_val"] <= 1.0
    assert all(hk.LAUNCHES[k] > before[k]
               for k in ("spmm_ell", "spmm_bucketed"))
    phase("q_halving", trials=16, rung_epochs=REFINE_EPOCHS // 4,
          epochs=REFINE_EPOCHS,
          survivors=res["survivors"], best_val=res["best_val"],
          test_auc=res["test_auc"], winner=res["winner"])
    res = tp.refine_adaptive(data, cfg, run_q, n_trials=16, n_batches=4,
                             device=dev)
    assert res["configs_inspected"] == 16, res["configs_inspected"]
    assert len(res["round_best_vals"]) == 4
    assert res["best_val"] == max(res["val_aucs"])
    assert abs(res["best_val"] - max(res["round_best_vals"])) <= 1e-4
    assert 0.0 <= res["test_auc"] <= 1.0
    phase("q_adaptive", trials=16, rounds=4, epochs=REFINE_EPOCHS,
          round_best_vals=res["round_best_vals"], best_val=res["best_val"],
          test_auc=res["test_auc"], winner=res["winner"])

    # (r) the entry point, in this process, every output under a temporary
    # directory
    out = io.StringIO()
    before = dict(hk.LAUNCHES)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(out):
                cli.main(["twowl", "--epochs", "50", "--trials", "1",
                          "--refine", "8", "--refine-mode", "adaptive"])
            written = sorted(os.path.relpath(os.path.join(d, f), tmp)
                             for d, _, fs in os.walk(tmp) for f in fs)
        finally:
            os.chdir(cwd)
    lines = out.getvalue().strip().splitlines()
    auc = float(lines[-1].split()[0].removeprefix("AUC:"))
    assert lines[-1].startswith("AUC:") and 0.0 <= auc <= 1.0, lines[-1]
    assert "logs.json" in written, written
    assert all(hk.LAUNCHES[k] > before[k]
               for k in ("spmm_ell", "spmm_bucketed"))
    phase("r_cli_twowl_refine", auc=auc, printed=lines[-4:], written=written)

    # (s) width scan, f32: K3 on the train split's forward and transpose
    # operands and K1 on its message slots, each against the plain version,
    # the bucket-sum that 'plan' runs and the library call, in turns (at
    # three of the six widths of 32-1,024 it once scanned, to fit the
    # smoke's time: ROADMAP F6)
    bwd = trn.e1_cops[1]
    msg_plan = (trn.msg_plan[1], trn.msg_plan[2])
    for f in (32, 256, 1024):
        x, xm = feats(R, f), feats(S, f)
        line = {}
        for name, ops in (("k3_fwd", fwd), ("k3_bwd", bwd)):
            library, reason = library_spmm(
                lambda: bucketed_csr(*ops.k3[:4], R), x,
                hk.spmm_bucketed(x, *ops.k3))
            line[name] = in_turns({
                "kernel": lambda: hk.spmm_bucketed(x, *ops.k3),
                "plain": lambda: hk.spmm_bucketed_reference(x, *ops.k3),
                "bucket_sum": lambda: seg._bucket_sum(x, ops.inv_perm,
                                                      ops.buckets),
                "library": library})
            line[name]["bound_ms"] = bound(
                spmm_bucketed_work(x, *ops.k3))["bound_ms"]
            line[name]["device_kernel"] = device_kernels(
                lambda: hk.spmm_bucketed(x, *ops.k3))
        args = (trn.msg_slots, trn.msg_sweight, xm)
        library, reason = library_spmm(lambda: ell_csr(*args[:2], S), xm,
                                       hk.spmm_ell(*args))
        line["k1"] = in_turns({
            "kernel": lambda: hk.spmm_ell(*args),
            "plain": lambda: hk.spmm_ell_reference(*args),
            "bucket_sum": lambda: seg._bucket_sum(xm, *msg_plan),
            "library": library})
        line["k1"]["bound_ms"] = bound(spmm_ell_work(*args))["bound_ms"]
        phase("s_k_width_scan", f=f, dtype="float32", device_ms=line)

    return {"launches": launches, "by_width": by_width, "k1_err": k1_err,
            "k1_times": k1_times, "k3_err": k3_err, "k3_times": k3_times}


def walks_are_valid(walks, starts, eng):
    """On the device: the first column is `starts`, and every hop (a, b) is
    an edge of the engine's graph or a stall (a == b) at a degree-0 node."""
    if not torch.equal(walks[:, 0].long(), starts.long()):
        return False
    a, b = walks[:, :-1].reshape(-1).long(), walks[:, 1:].reshape(-1).long()
    deg = eng.degree.long()[a]
    live = torch.arange(eng.nbr.shape[1], device=walks.device)[None, :] \
        < deg[:, None]
    edge = ((eng.nbr[a].long() == b[:, None]) & live).any(dim=1)
    return bool((edge | ((a == b) & (deg == 0))).all())


def n2v_phases(dev, collab_graph):
    """(t)-(v): node2vec walks, SGNS embeddings and the logistic family, and
    the host plane's C++ beside them: the CSR/ELL build on the collab graph
    (`t_csr`) and the SGNS host baseline (in (u)). These paths run no
    hand-written kernel (the JAX package's run no Pallas kernel either): the
    walk and SGNS loops are gathers, fixed-order row sums
    (`ops.rows.add_rows_`) and matrix products.
    Returns phase (t)'s hops/s on the card by graph."""
    from linkpred_tpu_torch import native
    from linkpred_tpu_torch.data import io as dio
    from linkpred_tpu_torch.data import split as sp
    from linkpred_tpu_torch.data.graph import Graph
    from linkpred_tpu_torch.models import word2vec as w2v
    from linkpred_tpu_torch.ops.walk import WalkEngine, simulate_walks
    from linkpred_tpu_torch.pipelines import logistic_pipeline as lp

    def timed(fn):
        fn()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (t) walks: the logistic family's corpus (50 rounds over the 620-node
    # residual graph of fb-pages-food, length 16), then 65,536 walkers of
    # length 16 on the collab graph of phase (g), unweighted
    g_fb, edges = dio.load_fb_pages_food()
    removable = sp.removable_positive_edges(edges, g_fb.num_nodes)
    keep = np.setdiff1d(np.arange(len(edges)), removable)
    residual = Graph.from_undirected_edges(edges[keep, 0], edges[keep, 1],
                                           num_nodes=g_fb.num_nodes)
    gen = torch.Generator(device=dev).manual_seed(0)
    eng = WalkEngine(residual, device=dev)
    walks, dt = timed(lambda: eng.walks(gen, 50, 16))
    starts = torch.arange(residual.num_nodes, device=dev).repeat(50)
    assert walks.shape == (50 * residual.num_nodes, 16)
    assert walks.dtype == torch.int32 and walks_are_valid(walks, starts, eng)
    phase("t_walks", graph="fb-pages-food residual", walkers=len(walks),
          length=16, seconds=dt, hops_per_s=len(walks) * 15 / dt)
    rates = {"fb": len(walks) * 15 / dt}

    t0 = time.perf_counter()
    big = WalkEngine(dataclasses.replace(collab_graph, nbr_weight=None),
                     device=dev)
    table_seconds = time.perf_counter() - t0
    starts = torch.as_tensor(np.random.default_rng(3).integers(
        0, collab_graph.num_nodes, 65_536), device=dev)
    walks, dt = timed(lambda: simulate_walks(
        gen, starts, big.nbr, big.indptr, big.degree, big.node_J, big.node_q,
        big.edge_J, big.edge_q, 16))
    assert walks.shape == (65_536, 16) and walks_are_valid(walks, starts, big)
    phase("t_walks", graph="collab", nodes=collab_graph.num_nodes,
          directed_edges=collab_graph.num_edges, walkers=65_536, length=16,
          table_build_seconds=table_seconds, seconds=dt,
          hops_per_s=65_536 * 15 / dt)
    rates["collab"] = 65_536 * 15 / dt
    del big

    # t_csr: the C++ CSR/ELL build on the collab graph's directed message
    # edges after the degree cap, in an order drawn from a seed (the graph
    # holds them sorted), against its numpy path and the port's
    # `Graph.from_edges` on the same edges, each timed twice in turns
    assert native.available(), "the host plane's C++ library did not load"
    n = collab_graph.num_nodes
    perm = np.random.default_rng(13).permutation(collab_graph.num_edges)
    src, dst = collab_graph.src[perm], collab_graph.dst[perm]
    builds = {"cpp": native.build_csr_ell,
              "numpy": native.build_csr_ell_numpy,
              "graph_from_edges": lambda s, d, n: Graph.from_edges(
                  s, d, num_nodes=n)}
    built, seconds = {}, {name: [] for name in builds}
    for name in [*builds, *reversed(builds)]:
        t0 = time.perf_counter()
        built[name] = builds[name](src, dst, n)
        seconds[name].append(time.perf_counter() - t0)
    order, indptr, nbr, mask, degree = built["cpp"]
    ref, g = built["numpy"], built["graph_from_edges"]
    for a, b in zip((indptr, nbr, mask, degree), ref[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the C++ sorts a row with std::sort, which is not stable: among
    # duplicate edges only the edges that `order` puts in place must agree
    assert np.array_equal(src[order], src[ref[0]])
    assert np.array_equal(dst[order], dst[ref[0]])
    duplicates = len(src) - len(np.unique(src.astype(np.int64) * n + dst))
    assert duplicates > 0 or np.array_equal(order, ref[0])
    assert all(np.array_equal(a, b) for a, b in (
        (indptr, g.indptr), (nbr, g.nbr), (mask, g.nbr_mask),
        (degree, g.degree), (src[order], g.src), (dst[order], g.dst)))
    assert nbr.shape == (n, int(degree.max())) and degree.max() <= 64
    phase("t_csr", graph="collab, degree cap 64", nodes=n,
          directed_edges=len(src), ell_width=nbr.shape[1],
          duplicate_edges=duplicates, cpp_seconds=seconds["cpp"],
          numpy_seconds=seconds["numpy"],
          graph_from_edges_seconds=seconds["graph_from_edges"],
          numpy_over_cpp=min(seconds["numpy"]) / min(seconds["cpp"]),
          equal_to_numpy=True)
    del built, ref, g, order, indptr, nbr, mask, degree

    # (u) SGNS at the shape of the reference's throughput gate: a 235,000 x
    # 128 table, a 65,536 x 16 corpus of uniform tokens, 1 epoch, batch
    # 65,536, beside the gate's measured host baseline (`bench.py:282-294`:
    # gensim's loop in C++ on every core the host reports, over a quarter
    # of the corpus, timed with its host-side set-up); then two cliques
    # joined by one edge, whose embeddings must separate
    n_vocab = 235_000
    tokens = np.random.default_rng(5).integers(0, n_vocab, (65_536, 16),
                                               dtype=np.int32)
    corpus = torch.as_tensor(tokens, device=dev)
    cfg = w2v.SGNSConfig(dim=128, epochs=1, batch_size=65_536)
    prep = w2v.prepare_sgns(corpus, n_vocab, cfg)
    steps = w2v.sgns_schedule(corpus.numel(), n_vocab, cfg)[1]
    emb, dt = timed(lambda: w2v.train_sgns_device(gen, corpus, n_vocab, cfg,
                                                  prep))
    assert emb.shape == (n_vocab, 128) and torch.isfinite(emb).all()
    del emb
    tokens_per_s = corpus.numel() * cfg.epochs / dt
    t0 = time.perf_counter()
    syn0, words = native.sgns_train_ref(tokens[:16_384], n_vocab, dim=128,
                                        epochs=1, n_threads=0)
    host_dt = time.perf_counter() - t0
    assert words == 16_384 * 16, words
    assert syn0.shape == (n_vocab, 128) and np.isfinite(syn0).all()
    del syn0
    host_rate = words / host_dt
    phase("u_sgns", table=[n_vocab, 128], corpus=list(corpus.shape),
          steps=steps, seconds=dt, host_prep_seconds=prep.prep_seconds,
          tokens_per_s=tokens_per_s,
          pairs_per_s=corpus.numel() * cfg.window * 2 * cfg.epochs / dt,
          steps_per_s=steps / dt, host_corpus=[16_384, 16],
          host_seconds=host_dt, host_measured_words_per_s=host_rate,
          host_threads=os.cpu_count(),
          host_affinity_cpus=len(os.sched_getaffinity(0)),
          gensim_cited_words_per_s=450_000,
          device_over_host=tokens_per_s / host_rate,
          beats_host_measured=tokens_per_s > host_rate,
          beats_gensim_cited=tokens_per_s > 450_000)
    # (u_repeat) the same training twice from one seed: both tables (the
    # row updates of a step add a hub's terms in a fixed order)
    repeat_phase(
        "u_sgns_repeat", lambda: w2v.train_sgns_tables(
            torch.Generator(device=dev).manual_seed(11), corpus, n_vocab, cfg,
            prep),
        lambda tables: {"w_in": tables[0], "w_out": tables[1]},
        table=[n_vocab, 128], corpus=list(corpus.shape), steps=steps)
    k = 8
    src, dst = [], []
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                src.append(base + i)
                dst.append(base + j)
    cliques = Graph.from_undirected_edges(np.array(src + [k - 1]),
                                          np.array(dst + [k]),
                                          num_nodes=2 * k)
    walks = WalkEngine(cliques, device=dev).walks(gen, 40, 20)
    emb = w2v.train_sgns(gen, walks, 2 * k, w2v.SGNSConfig(
        dim=16, window=4, epochs=3, batch_size=1024))
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sim = emb @ emb.T
    within = (sim[:k, :k].sum() - k) / (k * (k - 1))
    across = sim[:k, k:].mean()
    assert np.isfinite(emb).all() and within > across + 0.2, (within, across)
    phase("u_sgns_cliques", within_cosine=float(within),
          across_cosine=float(across))

    # (v) the logistic family end to end at its default config, seed 35,
    # every output under a temporary directory, no plot
    def logistic(seed, out):
        """`run_logistic` at `seed`, printing to `out`: (its result, its
        SGNS embeddings, the temporary directory's record lines and whether
        it wrote the metrics file)."""
        with tempfile.TemporaryDirectory() as tmp:
            with contextlib.redirect_stdout(out), recording(
                    lp, "train_sgns_device") as emb:
                res = lp.run_logistic(
                    lp.LogisticConfig(seed=seed,
                                      records_dir=os.path.join(tmp, "rec")),
                    device=dev, roc_png=None,
                    metrics_file=os.path.join(tmp, "metrics.jsonl"))
            with open(os.path.join(
                    tmp, "rec", "fb-pages-food_auc_record_logistic.txt")) as f:
                record = f.read().splitlines()
            wrote = os.path.getsize(os.path.join(tmp, "metrics.jsonl")) > 0
        return res, emb[0], record, wrote

    runs = {}
    for seed in (35,):
        out = io.StringIO()
        res, emb, record, wrote = runs[seed] = logistic(seed, out)
        assert wrote
        assert len(record) == 1 and record[0].startswith("AUC:"), record
        assert res["auc"] >= LOGISTIC_AUC_FLOOR, res["auc"]
        spans = {ln.split(":")[0].strip(): float(ln.split(":")[1].split()[0])
                 for ln in out.getvalue().splitlines()
                 if ln.rstrip().endswith(" s")}
        phase("v_run_logistic", seed=seed, auc=res["auc"],
              fit_seconds=res["fit_seconds"], num_pos=res["num_pos"],
              num_neg=res["num_neg"], record=record[0], spans=spans)
    # (v_repeat) seed 35 once more: the test AUC and the SGNS embeddings
    # bit for bit against phase (v)'s run (the first of the two)
    repeat_phase(
        "v_logistic_repeat", lambda: logistic(35, io.StringIO()),
        lambda r: {"test_auc": r[0]["auc"], "embeddings": r[1]},
        first=runs[35], seed=35, first_run="phase v's")
    return rates


def scale_phases(dev, hk):
    """(w)-(y): TwoWL at 50k nodes at the full published config, K1 and K3
    at its shapes, and the new entry points in-process. Returns the main
    run's launch counts and the kernels' errors and times at these shapes
    for the kernels line."""
    from linkpred_tpu_torch import cli
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.ops import segment as seg
    from linkpred_tpu_torch.pipelines import twowl_scale as ts

    bf16 = torch.bfloat16
    cfg = ts.ScaleTwoWLConfig()

    # (w) the main path: `run_twowl_scale` at its defaults (50,000 nodes,
    # 250,000 edges, degree cap 32, ei2 cap 128, channels 24/16, depths 2/2,
    # bf16, 96 epochs, val every 4th, batch 8,192, n2v seeding). The launch
    # counts are zeroed just before and read just after.
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    hk.LAUNCHES_BY_WIDTH.clear()
    res = ts.run_twowl_scale(cfg, device=dev, agg_1wl="ell", verbose=False)
    launches, by_width = dict(hk.LAUNCHES), dict(hk.LAUNCHES_BY_WIDTH)
    assert set(res) == SCALE_KEYS, sorted(res)
    assert res["epochs"] == cfg.epochs and res["loss_decreased"], res
    assert res["test_auc"] >= SCALE_AUC_FLOOR, res
    assert launches["spmm_ell"] > 0 and launches["spmm_bucketed"] > 0, launches
    assert by_width.get("spmm_bucketed F=1") and by_width.get(
        "spmm_ell F=16"), by_width
    phase("w_twowl_scale", launches=launches, launches_by_width=by_width,
          **res)

    # the same data and seeding once more, for the turns and for phase (x)
    t0 = time.perf_counter()
    data = ts.build_scale_data(cfg)
    build_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    trn = m.SplitArrays.from_split(data.train, dev)
    val = m.SplitArrays.from_split(data.val, dev)
    torch.cuda.synchronize()
    operand_seconds = time.perf_counter() - t0
    emb0 = ts.n2v_embeddings(cfg, data, dev, 1)

    def fresh_params(agg):
        p = m.init_params(ts.model_config(cfg, data, agg),
                          torch.Generator().manual_seed(0), dev)
        with torch.no_grad():
            p["emb"].copy_(emb0)
        return p

    def run(agg, epochs):
        return ts.train_and_score(dataclasses.replace(cfg, epochs=epochs),
                                  data, (trn, val), fresh_params(agg), dev,
                                  agg)

    rates = launch_rates(lambda n: run("ell", 4 * n), hk)
    rates = {k: v / 4 for k, v in rates.items()}  # a val pass every 4th epoch
    phase("w_scale_data", build_seconds=build_seconds,
          operand_seconds=operand_seconds, msg_edges=trn.num_msg,
          rows=trn.num_rows, k1_slots=list(trn.msg_slots.shape),
          ei2_slots=len(data.train.e1_src),
          buckets_fwd=[list(b) for b in trn.e1_cops[0].k3[1]],
          buckets_bwd=[list(b) for b in trn.e1_cops[1].k3[1]],
          launches_per_epoch=rates)

    # (w_repeat) the same entry point cut to 8 epochs, twice from one seed,
    # the node2vec seeding included: every loss (read from the epoch loop,
    # its warm-up too), the best val AUC and the test AUC. Both runs take
    # the host-built graph and splits above (numpy, the arrays every build
    # of this config gives), which saves two builds' seconds
    def scale_short():
        with recording(m, "train_loop") as loops, mock.patch.object(
                ts, "build_scale_data", lambda c: data):
            out = ts.run_twowl_scale(
                dataclasses.replace(cfg, epochs=REPEAT_SCALE_EPOCHS),
                device=dev, agg_1wl="ell", verbose=False)
        return out, loops

    repeat_phase(
        "w_scale_repeat", scale_short,
        lambda r: {"losses": torch.cat([loop[3][0] for loop in r[1]]),
                   "val_aucs": torch.cat([loop[3][1] for loop in r[1]]),
                   "best_val_auc": r[0]["best_val_auc"],
                   "test_auc": r[0]["test_auc"]},
        epochs=REPEAT_SCALE_EPOCHS)

    # 'ell' against 'plan' in turns, then a profile of 8 epochs of each, and
    # the two paths' test AUC after 24 epochs from the same start
    turns = [run(agg, SCALE_TURN_EPOCHS)
             for agg in ("ell", "plan", "plan", "ell")]
    rate = [SCALE_TURN_EPOCHS / r["train_seconds"] for r in turns]
    profiles = {}
    pos_e, neg_e = (torch.as_tensor(a, dtype=torch.long, device=dev)
                    for a in ts.batch_schedule(cfg, data))
    val_y = torch.as_tensor(data.val.y, device=dev)
    for agg in ("ell", "plan"):
        c = ts.model_config(cfg, data, agg)
        p = fresh_params(agg)
        opt = m.adam(p, c.learning_rate)
        feat = torch.arange(data.num_nodes, device=dev)
        profiles[agg] = step_profile(
            lambda a, b: m.train_loop(
                p, opt, None, pos_e[a:b], neg_e[a:b], trn, val, val_y, feat,
                c, data.num_nodes, eval_every=cfg.eval_every),
            steps=8)
    parity = {agg: run(agg, SCALE_PARITY_EPOCHS) for agg in ("ell", "plan")}
    assert abs(parity["ell"]["test_auc"] - parity["plan"]["test_auc"]) \
        <= 0.02, parity
    phase("w_scale_turns", epochs=SCALE_TURN_EPOCHS,
          epochs_per_s=(rate[0] + rate[3]) / 2,
          plan_epochs_per_s=(rate[1] + rate[2]) / 2,
          epochs_per_s_ell_plan_plan_ell=rate,
          busy_share=busy_shares(profiles, rate), profile=profiles,
          parity_epochs=SCALE_PARITY_EPOCHS,
          test_auc={a: r["test_auc"] for a, r in parity.items()},
          best_val_auc={a: r["best_val_auc"] for a, r in parity.items()})

    # (x) K3 and K1 at the scale shapes, against their plain versions:
    # forward and transpose in bf16 (2C = 32 channels) and f32, the F = 1
    # degree pass, the gradient of the composed gather-sum in bf16; K1 on
    # the `[50000, 32]` slots at F = 24 and 16. Then timed as (m) and (n).
    gen = torch.Generator(device=dev).manual_seed(3)

    def feats(rows, f, dtype=torch.float32):
        return torch.randn((rows, f), generator=gen, device=dev).to(dtype)

    R, S = trn.num_rows, trn.num_msg
    k3_err = {"bf16": 0.0, "f32": 0.0}
    for name, ops in (("fwd", trn.e1_cops[0]), ("bwd", trn.e1_cops[1]),
                      ("val fwd", val.e1_cops[0])):
        rows = ops.k3[0].shape[0]
        for f, dtype, tol in ((32, bf16, BF16_TOL), (32, torch.float32,
                                                     F32_TOL),
                              (1, torch.float32, F32_TOL)):
            x = feats(rows, f, dtype)
            before = hk.LAUNCHES["spmm_bucketed"]
            got = hk.spmm_bucketed(x, *ops.k3)
            assert hk.LAUNCHES["spmm_bucketed"] == before + 1
            err = check(f"scale {name} F={f} {dtype}", got,
                        hk.spmm_bucketed_reference(x, *ops.k3), tol)
            key = "bf16" if dtype == bf16 else "f32"
            k3_err[key] = max(k3_err[key], err)
            phase("x_k3_scale_check", case=name, x=list(x.shape),
                  dtype=str(dtype), slots=int(ops.k3[2].shape[0]),
                  max_abs_err=err)
    x, cot = feats(R, 32, bf16), feats(R, 32, bf16)
    grads = []
    for kernel in (True, False):
        xx = x.clone().requires_grad_()
        seg.gather_sum_composed(xx, *trn.e1_cops, kernel).backward(cot)
        grads.append(xx.grad)
    err = check("scale gather_sum_composed grad bf16", grads[0], grads[1],
                BF16_TOL)
    k3_err["bf16"] = max(k3_err["bf16"], err)
    phase("x_k3_scale_grad", x=list(x.shape), max_abs_err=err)
    k3_time = {}
    for name, ops, f, dtype in (("fwd", trn.e1_cops[0], 32, bf16),
                                ("bwd", trn.e1_cops[1], 32, bf16),
                                ("fwd", trn.e1_cops[0], 1, torch.float32)):
        x = feats(R, f, dtype)
        library, reason = library_spmm(
            lambda: bucketed_csr(*ops.k3[:4], R, dtype=dtype), x,
            hk.spmm_bucketed(x, *ops.k3))
        case = f"scale {name} F={f} {str(dtype).removeprefix('torch.')}"
        k3_time[case] = report(
            time_in_turns(lambda: hk.spmm_bucketed_reference(x, *ops.k3),
                          lambda: hk.spmm_bucketed(x, *ops.k3)),
            spmm_bucketed_work(x, *ops.k3), hk, dev, library, reason,
            launches_per_epoch=rates.get(f"spmm_bucketed F={f}", 0))
        phase("x_k3_scale_time", case=case, **k3_time[case],
              device_kernel=device_kernels(
                  lambda: hk.spmm_bucketed(x, *ops.k3)),
              bucket_sum=time_in_turns(
                  lambda: seg._bucket_sum(x, ops.inv_perm, ops.buckets),
                  lambda: hk.spmm_bucketed(x, *ops.k3)))
    k1_err, k1_time = 0.0, {}
    for f in (24, 16):
        args = (trn.msg_slots, trn.msg_sweight, feats(S, f))
        before = hk.LAUNCHES["spmm_ell"]
        got = hk.spmm_ell(*args)
        assert hk.LAUNCHES["spmm_ell"] == before + 1
        err = check(f"scale K1 F={f}", got, hk.spmm_ell_reference(*args),
                    F32_TOL)
        k1_err = max(k1_err, err)
        library, reason = library_spmm(lambda: ell_csr(*args[:2], S), args[2],
                                       got)
        k1_time[f] = report(
            time_in_turns(lambda: hk.spmm_ell_reference(*args),
                          lambda: hk.spmm_ell(*args)),
            spmm_ell_work(*args), hk, dev, library, reason,
            launches_per_epoch=rates.get(f"spmm_ell F={f}", 0))
        phase("x_k1_scale", shape=[list(a.shape) for a in args],
              max_abs_err=err, **k1_time[f])
    del trn, val, data

    # (y) the new entry points, in this process, under a temporary directory
    cwd = os.getcwd()
    edge_file = os.path.join(cwd, "raw_data", "fb-pages-food",
                             "fb-pages-food.edges")
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            printed = {}
            for name, argv in (
                    ("logistic", ["logistic"]),
                    ("node2vec", ["node2vec", "--input", edge_file,
                                  "--output", "fb.emb", "--walks-output",
                                  "fb.walks", "--walk-length", "16",
                                  "--dimensions", "32"]),
                    ("scale twowl", ["scale", "--family", "twowl", "--nodes",
                                     "5000", "--edges", "25000", "--steps",
                                     "16"])):
                out = io.StringIO()
                before = dict(hk.LAUNCHES)
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(io.StringIO()):
                    cli.main(argv)
                printed[name] = out.getvalue().strip().splitlines()
            written = sorted(os.path.relpath(os.path.join(d, f), tmp)
                             for d, _, fs in os.walk(tmp) for f in fs)
            with open("fb.emb") as f:
                header = f.readline().split()
                first = f.readline().split()
            walks_rows = sum(1 for _ in open("fb.walks"))
        finally:
            os.chdir(cwd)
    auc = float(printed["logistic"][-1].split()[0].removeprefix("AUC:"))
    assert auc >= LOGISTIC_AUC_FLOOR, printed["logistic"][-1]
    assert "records_auc/fb-pages-food_auc_record_logistic.txt" in written
    assert header[1] == "32" and len(first) == 33 and first[0] == "1", header
    assert walks_rows == 10 * int(header[0]), (walks_rows, header)
    res_cli = json.loads(printed["scale twowl"][-1])
    assert set(res_cli) == SCALE_KEYS and res_cli["nodes"] == 5000
    assert res_cli["epochs"] == 16 and np.isfinite(res_cli["loss_last_quarter"])
    assert all(hk.LAUNCHES[k] > before[k]
               for k in ("spmm_ell", "spmm_bucketed"))
    phase("y_cli", logistic=printed["logistic"][-1],
          node2vec=printed["node2vec"], emb_header=header,
          scale_twowl=res_cli, written=written)

    return {"launches": launches, "by_width": by_width, "k1_err": k1_err,
            "k1_times": k1_time, "k3_err": k3_err, "k3_times": k3_time}


def seal_phases(dev, hk):
    """The SEAL group: DRNL on the card against the C++ plane, the DGCNN
    at `bench.py:gate_seal`'s synthetic shape, `run_seal` at the reference
    defaults, `run_seal_scale` at `bench.py:gate_collab_seal`'s config, the
    two CLI commands in-process, and the rest of the ops (`spmm_auto`'s
    regimes, the dispatch entries of K1 and K2). SEAL runs no hand-written
    kernel (the JAX package's runs no Pallas kernel either): dense `bmm`,
    a sort, `conv1d` and small GEMMs."""
    from linkpred_tpu_torch import cli, native
    from linkpred_tpu_torch.data import io as dio
    from linkpred_tpu_torch.data import subgraph as sg
    from linkpred_tpu_torch.data.graph import Graph
    from linkpred_tpu_torch.data.synth import synth_community_graph
    from linkpred_tpu_torch.models import seal
    from linkpred_tpu_torch.ops import spmm
    from linkpred_tpu_torch.pipelines import seal_pipeline as sp
    from linkpred_tpu_torch.pipelines import seal_scale as ss
    from linkpred_tpu_torch.utils.timer import StepTimer

    # the C++ plane is required: the extraction rate printed is its own
    assert native.available(), "the C++ host library did not build"

    # (seal_drnl) the fb-pages batch of `run_seal` at seed 0 (4,182 pairs, K
    # 100, the hop of the CN-vs-AA heuristic), built as `run_seal` builds it;
    # its DRNL tags on the card against the C++ plane's
    timer = StepTimer()
    data = sp.prepare(sp.SEALConfig(), None, device=dev, timer=timer)
    nodes, mask, adj, sizes = (data.batch.nodes, data.batch.node_mask,
                               data.batch.adj, data.batch.sizes)
    adj_d, mask_d = torch.as_tensor(adj, device=dev), torch.as_tensor(
        mask, device=dev)
    sg.drnl_tags(adj_d, mask_d)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tags = sg.drnl_tags(adj_d, mask_d).cpu().numpy()
    drnl_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = native.drnl_tags_batch(adj, mask, sizes)
    native_seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(tags, ref)
    phase("seal_drnl", pairs=len(data.pairs), K=100, hop=data.hop,
          mean_size=float(sizes.mean()), max_tag=int(tags.max()),
          spans=timer.spans, card_drnl_seconds=drnl_seconds,
          card_subgraphs_per_s=len(data.pairs) / drnl_seconds,
          native_drnl_seconds=native_seconds,
          native_subgraphs_per_s=len(data.pairs) / native_seconds)

    def steps_run(params, opt, bidx, stack, k, gen):
        return lambda a, b: seal.train_steps(params, opt, bidx[a:b], stack,
                                             k, seal.DROPOUT_RATE, gen)

    def timed_steps(run, steps):
        run(0, steps)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = run(0, steps)
        float(losses.sum())  # the host read closes the span
        return time.perf_counter() - t0, losses

    # (seal_gate) bench.py:gate_seal's synthetic shape: 2,048 subgraphs of
    # 50 nodes, 20 tags and a 235,000 x 32 embedding table, threshold_k 30,
    # batch 256, 8 steps; then a profile of 8 steps
    P, K, steps, bsz = 2048, 50, 8, 256
    rs = np.random.default_rng(6)
    a = (rs.random((P, K, K)) < 0.08).astype(np.uint8)
    a = np.maximum(a, a.transpose(0, 2, 1))
    stack = seal.CompactStack(
        torch.as_tensor(a, device=dev),
        torch.as_tensor(rs.integers(0, 20, (P, K)).astype(np.int32),
                        device=dev),
        torch.as_tensor(rs.integers(0, 235_000, (P, K)).astype(np.int32),
                        device=dev),
        torch.ones((P, K), dtype=torch.bool, device=dev),
        torch.as_tensor(rs.standard_normal((235_000, 32)).astype(np.float32),
                        device=dev),
        torch.as_tensor(rs.integers(0, 2, P), device=dev), 20)
    params = seal.init_params(torch.Generator().manual_seed(8), 20 + 32, 30,
                              dev)
    opt = seal.adam(params, 1e-4)
    bidx = torch.as_tensor(rs.integers(0, P, (2 + steps, bsz)), device=dev)
    run = steps_run(params, opt, bidx, stack, 30,
                    torch.Generator(device=dev).manual_seed(9))
    dt, losses = timed_steps(run, steps)
    assert torch.isfinite(losses).all()
    prof = step_profile(run, steps=steps)
    phase("seal_gate", subgraphs=P, K=K, batch=bsz, steps=steps,
          threshold_k=30, seconds=dt, subgraphs_per_s=steps * bsz / dt,
          steps_per_s=steps / dt,
          busy_share=prof["device_ms_per_step"] * steps / dt / 1e3,
          profile=prof)

    # the same for run_seal's own shape: the fb-pages batch and embedding
    # above, batch 32, its threshold_k, its schedule
    k = seal.threshold_from_sizes(sizes, 60.0)
    stack = seal.CompactStack.from_batch(data.batch, data.emb, data.labels,
                                         dev)
    params = seal.init_params(torch.Generator().manual_seed(0),
                              stack.tags_size + data.emb.shape[1], k, dev)
    opt = seal.adam(params, 1e-4)
    bidx = torch.as_tensor(data.batch_idx[:2 + 100], device=dev)
    run = steps_run(params, opt, bidx, stack, k,
                    torch.Generator(device=dev).manual_seed(1))
    dt, _ = timed_steps(run, 100)
    prof = step_profile(run, steps=10)
    phase("seal_steps", subgraphs=len(data.pairs), K=100, batch=32,
          threshold_k=k, steps=100, seconds=dt, steps_per_s=100 / dt,
          subgraphs_per_s=100 * 32 / dt,
          busy_share=prof["device_ms_per_step"] * 100 / dt / 1e3,
          profile=prof)
    steps_per_epoch = len(data.tr) // 32
    del stack, params, opt, adj_d, mask_d, data

    # (seal_run) the family end to end at the reference defaults (50
    # epochs, 117 steps an epoch, node2vec features), SEAL_SEEDS, every
    # output under a temporary directory, no plot
    for seed in SEAL_SEEDS:
        out = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp:
            with contextlib.redirect_stdout(out):
                res = sp.run_seal(
                    sp.SEALConfig(seed=seed,
                                  records_dir=os.path.join(tmp, "rec")),
                    device=dev, roc_png=None,
                    metrics_file=os.path.join(tmp, "metrics.jsonl"),
                    checkpoint_prefix=os.path.join(tmp, "ck", "model"))
            with open(os.path.join(
                    tmp, "rec", "fb-pages-food_auc_record_seal.txt")) as f:
                record = f.read().splitlines()
            assert os.path.exists(os.path.join(tmp, "ck", "model-1000.npz"))
        assert len(record) == 1 and record[0].startswith("AUC:"), record
        assert res["auc"] >= SEAL_AUC_FLOOR, res["auc"]
        spans = {ln.split(":")[0].strip(): float(ln.split(":")[1].split()[0])
                 for ln in out.getvalue().splitlines()
                 if ln.rstrip().endswith(" s")}
        n_steps = 50 * steps_per_epoch
        phase("seal_run", seed=seed, auc=res["auc"],
              accuracy=res["accuracy"], hop=res["hop"],
              threshold_k=res["threshold_k"],
              train_seconds=res["train_seconds"],
              steps_per_s=n_steps / res["train_seconds"],
              subgraphs_per_s=n_steps * 32 / res["train_seconds"],
              total_seconds=res["total_seconds"], record=record[0],
              spans=spans)

    # (seal_repeat) `run_seal` at seed 0 cut to 2 epochs, twice, its
    # node2vec features included: every loss (read from the step loop, its
    # warm-up too), the trained parameters and the test AUC
    def seal_short():
        with tempfile.TemporaryDirectory() as tmp, recording(
                seal, "train_steps") as losses:
            res = sp.run_seal(
                sp.SEALConfig(seed=0, epochs=REPEAT_SEAL_EPOCHS,
                              records_dir=os.path.join(tmp, "rec")),
                device=dev, verbose=False, roc_png=None,
                metrics_file=os.path.join(tmp, "metrics.jsonl"),
                checkpoint_prefix=None)
        return res, losses

    repeat_phase(
        "seal_repeat", seal_short,
        lambda r: {"losses": torch.cat([v.reshape(-1) for v in r[1]]),
                   "params": torch.cat([t.detach().reshape(-1) for t in
                                        seal.leaves(r[0]["params"])]),
                   "test_auc": r[0]["auc"]},
        seed=0, epochs=REPEAT_SEAL_EPOCHS)

    # (seal_scale) SEAL at collab scale, bench.py:gate_collab_seal's config:
    # 235,000 nodes, 4,096 subgraphs, 8 epochs of 57 steps
    res = ss.run_seal_scale(ss.ScaleSEALConfig(target_pairs=2048, epochs=8),
                            device=dev, verbose=False)
    assert set(res) == SEAL_SCALE_KEYS, sorted(res)
    assert res["loss_decreased"] and res["target_pairs"] == 4096, res
    n_steps = 8 * ((4096 - 2 * int(2048 * 0.1)) // 64)
    phase("seal_scale", steps=n_steps,
          train_subgraphs_per_s=n_steps * 64 / res["train_seconds"],
          steps_per_s=n_steps / res["train_seconds"], **res)

    # (seal_cli) `seal --epochs 5` and `scale --family seal` in this
    # process, under a temporary directory; the latter on 50,000 nodes (the
    # full graph's host build, 23-34 s, is paid once, in seal_scale)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            printed = {}
            for name, argv in (("seal", ["seal", "--epochs", "5"]),
                               ("scale seal", ["scale", "--family", "seal",
                                               "--nodes", "50000", "--edges",
                                               "250000"])):
                out = io.StringIO()
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(io.StringIO()):
                    cli.main(argv)
                printed[name] = out.getvalue().strip().splitlines()
            written = sorted(os.path.relpath(os.path.join(d, f), tmp)
                             for d, _, fs in os.walk(tmp) for f in fs)
        finally:
            os.chdir(cwd)
    line = printed["seal"][-1]
    assert line.startswith("AUC:") and "Time:" in line, line
    assert "records_auc/fb-pages-food_auc_record_seal.txt" in written
    assert "checkpoints/seal/model-1000.npz" in written, written
    res_cli = json.loads(printed["scale seal"][-1])
    assert set(res_cli) == SEAL_SCALE_KEYS and res_cli["nodes"] == 50_000
    assert np.isfinite(res_cli["loss_last_quarter"]), res_cli
    phase("seal_cli", seal=line, scale_seal=res_cli, written=written)

    # (m3_ops) the rest of ops/spmm.py and ops/segment.py on the card:
    # `spmm_auto` in each regime ('pallas' = K1, 'bucketed' = K3, 'ell'
    # plain; by default 'ell' on fb-pages-food, 'bucketed' on a community
    # graph of 20,000 nodes)
    # and the dispatch entries of K1 and K2, against the plain versions
    gen = torch.Generator(device=dev).manual_seed(4)
    errs, launched = {}, {}
    lo, hi = synth_community_graph(20_000, 100_000, seed=0)
    for name, graph in (("fb-pages-food", dio.load_fb_pages_food()[0]),
                        ("community 20000", Graph.from_undirected_edges(
                            lo, hi, num_nodes=20_000))):
        x = torch.randn((graph.num_nodes, 64), generator=gen, device=dev)
        w = np.random.default_rng(1).random(graph.nbr.shape).astype(
            np.float32)
        nbr, msk, wt = (torch.as_tensor(t, device=dev)
                        for t in (graph.nbr, graph.nbr_mask, w))
        plain = spmm.spmm_ell(nbr, msk, x, wt)
        for force in ("pallas", "bucketed", "ell", None):
            before = dict(hk.LAUNCHES)
            got = spmm.spmm_auto(graph.nbr, graph.nbr_mask, x, w, force=force)
            errs[f"{name} {force}"] = check(f"spmm_auto {name} {force}", got,
                                            plain, F32_TOL)
            launched[f"{name} {force}"] = {
                k: hk.LAUNCHES[k] - before[k] for k in before
                if hk.LAUNCHES[k] != before[k]}
        errs[f"{name} spmm_ell_auto"] = check(
            "spmm_ell_auto", hk.spmm_ell_auto(nbr, msk, x, wt), plain,
            F32_TOL)
        src = torch.as_tensor(graph.src, device=dev)
        dst = torch.as_tensor(graph.dst, device=dev)
        y = torch.randn_like(x)
        errs[f"{name} sddmm_auto"] = check(
            "sddmm_auto", hk.sddmm_auto(src, dst, x, y),
            hk.sddmm_reference(src, dst, x, y), K2_TOL)
    assert launched["fb-pages-food None"] == {}, launched
    assert launched["community 20000 None"] == {"spmm_bucketed": 1}, launched
    assert launched["fb-pages-food pallas"] == {"spmm_ell": 1}, launched
    phase("m3_ops", max_abs_err=errs, launches=launched)


def trace_kernel_names(log_dir):
    """The card's kernel names in the one trace file under `log_dir`."""
    (name,) = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    path = os.path.join(log_dir, name)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return path, {e["name"] for e in events if e.get("cat") == "kernel"}


def files_under(root):
    """Every file under `root`, but in `.git` and `__pycache__` (a module
    imported for the first time writes its bytecode there)."""
    out = []
    for d, dirs, fs in os.walk(root):
        dirs[:] = [x for x in dirs if x not in (".git", "__pycache__")]
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs]
    return sorted(out)


def surface_phases(dev, hk):
    """The user surface: the entry point, the CLI's --profile-dir and --set,
    the host-only subcommands, and the TwoWL seed band's floor."""
    from linkpred_tpu_torch import cli
    from linkpred_tpu_torch.graft_entry import entry
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp

    repo = os.getcwd()

    # (surface_entry) the LocalWLNet forward of `entry()` on the card, with
    # the JAX entry point's 'plan' and on K1 and K3 ('ell'); the counts are
    # zeroed just before the 'ell' run and read just after
    fn, args = entry()
    assert args[1].is_cuda
    plan = fn(*args)
    fn, args = entry(agg_1wl="ell")
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    ell = fn(*args)
    torch.cuda.synchronize()
    launches = dict(hk.LAUNCHES)
    assert launches["spmm_ell"] > 0 and launches["spmm_bucketed"] > 0, \
        launches
    check("entry ell vs plan", ell, plan, F32_TOL)
    assert torch.isfinite(ell).all()
    phase("surface_entry", shape=list(ell.shape),
          max_abs_diff=float((ell - plan).abs().max()), launches=launches)

    def cli_in(tmp, argv):
        """`cli.main(argv)` in this process with `tmp` as the working
        directory; returns the printed lines and the files written."""
        out = io.StringIO()
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(io.StringIO()):
                cli.main(argv)
        finally:
            os.chdir(repo)
        return out.getvalue().strip().splitlines(), files_under(tmp)

    # (surface_profile) `--profile-dir` around `twowl --trials 1`: the trace
    # names K1's and K3's kernels; every output lands under the temporary
    # directory, none in the repository
    record = os.path.join(repo, "records_auc",
                          "fb-pages-food_auc_record_twowl.txt")
    with open(record, "rb") as f:
        record_bytes = f.read()
    repo_files = files_under(repo)
    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof")
        for k in hk.LAUNCHES:
            hk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        lines, written = cli_in(tmp, [
            "--quiet", "--profile-dir", prof, "--set", "twowl.epochs=20",
            "twowl", "--trials", "1"])
        seconds = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
        trace, kernels = trace_kernel_names(prof)
        trace_mb = os.path.getsize(trace) / 2**20
    k1 = sorted(k for k in kernels if "spmm_ell" in k)
    k3 = sorted(k for k in kernels if "spmm_bucketed" in k)
    assert k1 and k3, sorted(kernels)[:20]
    assert launches["spmm_ell"] > 0 and launches["spmm_bucketed"] > 0, \
        launches
    assert lines[-1] == "wrote device trace to " + prof, lines
    assert lines[-2].startswith("AUC:") and \
        lines[-2].endswith("(best of 1 trials)"), lines
    assert "records_auc/fb-pages-food_auc_record_twowl.txt" in written
    with open(record, "rb") as f:
        assert f.read() == record_bytes
    assert files_under(repo) == repo_files, \
        sorted(set(files_under(repo)) ^ set(repo_files))
    phase("surface_profile", seconds=seconds, printed=lines[-2:],
          trace_mb=trace_mb, kernels_in_trace=len(kernels), k1_kernels=k1,
          k3_kernels=k3, launches=launches, written=written)

    # (surface_set) `--set twowl_trials=2 --set twowl.epochs=20 twowl`
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        lines, written = cli_in(tmp, ["--quiet", "--set", "twowl_trials=2",
                                      "--set", "twowl.epochs=20", "twowl"])
        seconds = time.perf_counter() - t0
        with open(os.path.join(
                tmp, "records_auc", "fb-pages-food_auc_record_twowl.txt")) as f:
            recs = f.read().splitlines()
    assert len(recs) == 2 and all(r.startswith("AUC:") for r in recs), recs
    assert lines[-1].startswith("AUC:") and \
        lines[-1].endswith("(best of 2 trials)"), lines
    phase("surface_set", seconds=seconds, printed=lines[-1], records=recs)

    # (surface_host) `report` and `stats --no-plot` as commands of their
    # own, in a directory holding copies of the committed results (`compare`
    # draws with matplotlib, which this machine may lack: the CPU tests hold
    # it to the JAX command)
    env = {**os.environ, "PYTHONPATH": repo}
    printed = {}
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(repo, "records_auc"),
                        os.path.join(tmp, "records_auc"))
        shutil.copy(os.path.join(repo, "logs.json"), tmp)
        for name, argv in (("report", ["report", "--output", "r.html"]),
                           ("stats", ["stats", "--no-plot"])):
            proc = subprocess.run(
                [sys.executable, "-m", "linkpred_tpu_torch.cli", *argv],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=120)
            assert proc.returncode == 0, (name, proc.stderr[-2000:])
            printed[name] = proc.stdout.strip().splitlines()
        with open(os.path.join(tmp, "r.html")) as f:
            html = f.read()
    families = ("logistic", "seal", "twowl")
    assert all(f"<h2>{f} records</h2>" in html for f in families)
    assert all(f"<tr><td>{f}</td>" in html for f in families)
    phase("surface_host", report=printed["report"], stats=printed["stats"],
          html_bytes=len(html.encode()))

    # (surface_band) the TwoWL seed band's floor: one trial of the
    # published-best architecture on K1 and K3, 1,000 epochs with the early
    # stop at 800, the split drawn by default_rng(seed)
    edges, num_nodes = tp.load_edges()
    for seed in TWOWL_BAND_SEEDS:
        run = tp.TwoWLRunConfig(seed=seed)
        data = tp.build_data(edges, num_nodes, run,
                             np.random.default_rng(seed))
        cfg = m.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell")
        t0 = time.perf_counter()
        res = tp.train_routine_fused(data, cfg, run, dev)
        seconds = time.perf_counter() - t0
        assert res["test_auc"] >= TWOWL_AUC_FLOOR, (seed, res["test_auc"])
        phase("surface_band", seed=seed, test_auc=res["test_auc"],
              best_val=res["best_val"], floor=TWOWL_AUC_FLOOR,
              epochs=res["epochs_run"], seconds=seconds,
              train_seconds=res["train_seconds"])


# ---------------------------------------------------------------------------
# the parallel group: the multi-GPU stack as four gloo ranks on the one card
# ---------------------------------------------------------------------------

PAR_RANKS = 4
# one SGD step of the TwoWL step with the ei2 slots split over the ranks
# against the whole split's (the reference's own check, 1e-5)
PAR_SGD_TOL = 1e-5
# the trial-sharded sweep against the unsharded one, per trial, after 5
# Adam epochs at lr 1e-3 from the same parameters: K1 and K3 run at other
# widths (8 trials a rank against 32) and may take their other kernel, so
# sums come in other orders; Adam keeps f32 noise below lr-size steps at
# this lr (ROADMAP F1 protocol)
PAR_TRIAL_LOSS_RTOL, PAR_TRIAL_AUC_ATOL = 1e-3, 2e-3
# a DGCNN step with the batch split over the ranks against the whole
# batch's on the card (cuBLAS and cuDNN sum in other orders: the card
# test's DGCNN tolerance)
PAR_SEAL_TOL = dict(rtol=1e-4, atol=1e-6)
# the first 10 losses of a 4-rank train_collab (bf16) against the one-rank
# run from the same parameters and batches: the aggregations sum each row's
# slots in the same order (one bf16 ulp where the shard's K3 takes its
# other kernel), the weights' gradients add four blocks' f32 partials
PAR_LOSS_ATOL = 5e-3
PAR_LOSS_STEPS = 10
# the largest difference of a replicated weight between two ranks: their
# gradients are all-reduced before each step and Adam's update is
# elementwise, so the ranks hold one value
PAR_SPREAD_BOUND = 0.0
PAR_LABEL = "4 ranks on one card, gloo; not a scaling number"
# the feature widths of the GCN's two aggregations (emb_dim, hidden)
PAR_WIDTHS = (64, 128)
# the distributed node2vec (job C): the routed and the replicated walks'
# conditional hop frequencies against `WalkEngine.walks` on the card (the
# reference's bound between its two engines); the gathered SGNS table
# against the one-process replay of its sample stream (the reference's
# tolerance: the all-reduced scores sum in another order); the one-rank
# NCCL run against the one-shard replay (the same sums)
PAR_FREQ_ATOL = 0.12
PAR_SGNS_TOL = dict(atol=2e-4, rtol=1e-3)
PAR_NCCL_SGNS_TOL = 1e-6
PAR_N2V_SEED = 36  # the logistic family's SGNS seed at its seed 35
# the routed walk on the collab graph: per-destination capacity at twice
# the reference's default (4x the mean load of a pair of ranks, + 16). The
# power-law graph puts 62.5 % of its directed edges in the first node block
# (the hubs), and walkers crowd it beyond the default; the run at the
# default is reported beside this one (its loss), not gated
PAR_COLLAB_CAP_FACTOR = 2


def _par_x(rows, f, dtype, seed):
    """Features drawn on the host from `seed`: the same on every rank."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((rows, f), generator=g).to(dtype)


def _padded(x, rows_total):
    return torch.cat([x, x.new_zeros((rows_total - x.shape[0], x.shape[1]))])


def _halo_table_rows(lay, k):
    """Global (relabelled) rows of rank `k`'s local table `[own | ghosts |
    hubs]` in `spmm_halo`: what its K3 launch reads."""
    rows, s = lay.rows_per_shard, lay.n_shards
    own = np.arange(k * rows, (k + 1) * rows)
    ghosts = [j * rows + lay.send_idx[j, k] for j in range(s)]
    hubs = ([j * rows + lay.hub_send[j] for j in range(s)]
            if lay.hub_capacity else [])
    return np.concatenate([own, *ghosts, *hubs])


def par_ops_rank(rank, world, dev, grp, inputs, save_dir):
    """par_ops on this rank: every sharded SpMM at collab scale, at both
    widths of the GCN's aggregations (F = 64, the embedding, and F = 128,
    the hidden layer: at 58,750 output rows a rank K3 runs its packed
    kernel at both widths in both types, two rows a warp, where the one-rank
    layout's 235,000 rows take four or two), against the one-rank K3 and
    against K3's plain version; rank 0 saves its bf16 operands of each
    width for the timings. Returns errors and K3 launches."""
    from linkpred_tpu_torch.ops import hopper_kernels as hk
    from linkpred_tpu_torch.parallel import collectives as C
    from linkpred_tpu_torch.parallel import halo as H
    from linkpred_tpu_torch.parallel import spmm_shard as S

    N, rows = inputs["nodes"], inputs["ns"]["rows_per_shard"]
    whole_ops = tuple(torch.as_tensor(a).to(dev) if isinstance(a, np.ndarray)
                      else a for a in inputs["whole_ops"])
    ops = S.node_sharded_operands(inputs["ns"]["stacked"], rank, dev)
    err, before = {}, hk.LAUNCHES["spmm_bucketed"]
    own = slice(rank * rows, min((rank + 1) * rows, N))
    n_own = own.stop - own.start
    saved = {}

    def cpu(t):
        return tuple(a.cpu() if torch.is_tensor(a) else a for a in t)

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for f in PAR_WIDTHS:
            tag = ("bf16" if dtype == torch.bfloat16 else "f32") + f" F={f}"
            keep = rank == 0 and dtype == torch.bfloat16
            x = _par_x(N, f, dtype, 1).to(dev)
            t = _par_x(N, f, dtype, 2).to(dev)
            whole_x = hk.spmm_bucketed(x, *whole_ops)
            whole_t = hk.spmm_bucketed(t, *whole_ops)

            def vs(name, got, one_rank, plain_ref):
                # this rank's real rows against the one-rank K3; all its
                # rows (the last block's padding too) against the plain
                # version
                err[f"{name} {tag} vs one rank"] = check(
                    name, got[: one_rank.shape[0]], one_rank, tol)
                err[f"{name} {tag} vs plain"] = check(name, got, plain_ref,
                                                      tol)

            out = S.spmm_node_sharded(grp, x, N, rows, ops)
            vs("node_sharded", out, whole_x[own],
               hk.spmm_bucketed_reference(x, *ops))
            xb = _padded(x, rows * world)[rank * rows:(rank + 1) * rows]
            for chunks in (1, 2, 4):
                p = S.spmm_node_sharded_pipelined(grp, xb.contiguous(), N,
                                                  rows, ops, chunks)
                vs(f"pipelined {chunks}", p, whole_x[own],
                   hk.spmm_bucketed_reference(x, *ops))
            xs = x.clone().requires_grad_()
            sym = S.spmm_node_sharded_sym(grp, xs, N, rows, ops)
            tb = _padded(t, rows * world)[rank * rows:(rank + 1) * rows]
            (sym.float() * tb.float()).sum().backward()
            vs("node_sharded_sym grad", xs.grad[own], whole_t[own],
               hk.spmm_bucketed_reference(_padded(t, rows * world),
                                          *ops)[:n_own])
            if keep:
                saved[f"node_sharded F={f}"] = (x.cpu(), cpu(ops))
            for name, lay in inputs["halo"].items():
                hops = lay.operands(rank, dev)
                order = torch.as_tensor(lay.order, device=dev)
                rows_h = lay.rows_per_shard
                own_h = slice(rank * rows_h, min((rank + 1) * rows_h, N))
                x_new = _padded(x[order], rows_h * world)
                t_new = _padded(t[order], rows_h * world)
                xh = x_new[own_h.start:own_h.start + rows_h].clone()
                xh.requires_grad_()
                hout = H.spmm_halo_sym(grp, xh, hops)
                (hout.float() * t_new[own_h.start:own_h.start + rows_h]
                 .float()).sum().backward()
                table_rows = torch.as_tensor(_halo_table_rows(lay, rank),
                                             device=dev)
                table, tab_t = x_new[table_rows], t_new[table_rows]
                err[f"halo {name} {tag} local K3 again"] = check(
                    "halo table", hk.spmm_bucketed(table, *hops.k3),
                    hout.detach(), dict(rtol=0, atol=0))
                vs(f"halo {name}", hout.detach(), whole_x[order][own_h],
                   hk.spmm_bucketed_reference(table, *hops.k3))
                vs(f"halo {name} grad", xh.grad, whole_t[order][own_h],
                   hk.spmm_bucketed_reference(tab_t, *hops.k3))
                if keep and name == "train":
                    saved[f"halo F={f}"] = (table.cpu(), cpu(hops.k3))
            if f != PAR_WIDTHS[-1]:
                continue
            # the pair scoring's gather and K2 on it (on the hidden layer's
            # rows), as the sharded step runs it
            ids = torch.as_tensor(inputs["pairs"], device=dev)
            table = C.gather_by_id(_padded(x, rows * world)[
                rank * rows:(rank + 1) * rows], torch.cat([ids[0], ids[1]]),
                grp)
            e = ids.shape[1]
            ar = torch.arange(e, device=dev, dtype=torch.int32)
            err[f"gather_by_id {tag}"] = check(
                "gather_by_id", table, torch.cat([x[ids[0]], x[ids[1]]]),
                dict(rtol=0, atol=0))
            err[f"sddmm {tag} vs plain"] = check(
                "sddmm", hk.sddmm(ar, ar + e, table, table),
                hk.sddmm_reference(ar, ar + e, table, table), K2_TOL)
            cot = _par_x(e, 1, torch.float32, 3)[:, 0].to(dev)
            err[f"sddmm_grad {tag} vs plain"] = check(
                "sddmm_grad", hk.sddmm_grad(cot, ar, ar + e, table)[0],
                hk.sddmm_grad_reference(cot, ar, ar + e, table)[0], tol)
            if keep:
                saved["sddmm"] = (ar.cpu(), (ar + e).cpu(), table.cpu())
    if rank == 0:
        torch.save(saved, os.path.join(save_dir, "rank0_operands.pt"))
    return err, hk.LAUNCHES["spmm_bucketed"] - before


def par_twowl_rank(rank, world, dev, mesh, inputs):
    """par_twowl on this rank: one SGD step with the ei2 slots split over
    the ranks against the whole split's, then 32 trials x 5 epochs with the
    trial axis split over the ranks (counted: the K1 and K3 launches of
    that run), and on rank 0 the unsplit run of all 32 trials."""
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.ops import hopper_kernels as hk
    from linkpred_tpu_torch.parallel import collectives as C
    from linkpred_tpu_torch.parallel import dp
    from linkpred_tpu_torch.parallel import make_mesh
    import torch.distributed as dist

    data, cfg = inputs["data"], inputs["cfg"]
    world_grp = dist.group.WORLD
    P = 8
    pos = torch.arange(P, device=dev)
    neg = torch.arange(P, device=dev)
    leaves = {}
    for name, arrays in (("sharded", dp.shard_twowl_split(mesh, data.train,
                                                          dev)),
                         ("whole", m.SplitArrays.from_split(data.train, dev))):
        params = m.init_params(cfg, torch.Generator().manual_seed(0), dev)
        sgd = torch.optim.SGD(m.tree_leaves(params), lr=cfg.learning_rate)
        dp.reduce_gradients_on_step(sgd, world_grp)
        m.train_step(params, sgd, None, pos, neg, arrays, cfg,
                     data.num_nodes)
        leaves[name] = m.tree_leaves(params)
    out = {"sgd_max_abs_dparam": max(
        float((a - b).detach().abs().max())
        for a, b in zip(leaves["sharded"], leaves["whole"])),
        "sgd_spread": C.max_spread(leaves["sharded"], world_grp)}

    tmesh = make_mesh(world, shape=(world, 1), device_type=dev.type)
    T = 32
    pos_e, neg_e = (torch.as_tensor(a, device=dev).long()
                    for a in inputs["batches"])
    trn = m.SplitArrays.from_split(data.train, dev)
    val = m.SplitArrays.from_split(data.val, dev)
    val_y = torch.as_tensor(data.val.y, dtype=torch.float32, device=dev)
    deg = torch.as_tensor(data.node_deg, dtype=torch.long, device=dev)

    def sweep(params, lrs, rates):
        return m.train_loop_trials(
            params, m.adam_trials_init(params), None, pos_e, neg_e, trn, val,
            val_y, deg, cfg, lrs, data.num_nodes, rates)

    params = m.init_params_trials(cfg, T, torch.Generator().manual_seed(3),
                                  dev)
    lrs = torch.full((T,), 1e-3, device=dev)
    rates = m.TrialRates(*[torch.zeros(T, device=dev)] * 4)
    p_k, _, l_k, r_k = dp.shard_twowl_trials(
        tmesh, params, m.adam_trials_init(params), lrs, rates)
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    _, best, (losses, aucs) = sweep(p_k, l_k, r_k)
    torch.cuda.synchronize(dev)
    out["launches"] = dict(hk.LAUNCHES)
    grp = tmesh.get_group("data")
    losses = C.all_gather_blocks(losses.T.contiguous(), grp).T
    aucs = C.all_gather_blocks(aucs.T.contiguous(), grp).T
    out["trials_here"] = int(l_k.shape[0])
    if rank == 0:
        _, best_all, (loss_all, auc_all) = sweep(params, lrs, rates)
        out["trial_loss_max_rel_diff"] = float(
            ((losses - loss_all).abs() / loss_all.abs()).max())
        out["trial_auc_max_abs_diff"] = float((aucs - auc_all).abs().max())
        out["mean_val_auc_last_epoch"] = float(auc_all[-1].mean())
    # K1 at this path's width, against its plain version
    slots, weight = trn.msg_slots, trn.msg_sweight
    x = _par_x(int(trn.num_msg), 8 * cfg.channels_1wl, torch.float32,
               4).to(dev)
    out["k1_err"] = check("K1 trial-sharded width",
                          hk.spmm_ell(slots, weight, x),
                          hk.spmm_ell_reference(slots, weight, x), F32_TOL)
    return out


def par_seal_rank(rank, world, dev, inputs):
    """par_seal on this rank: one SGD step of the DGCNN with the batch
    split over the ranks (each its rows of the whole batch's dropout mask)
    and, on rank 0, the one-process step on the whole batch."""
    from linkpred_tpu_torch.models import seal
    from linkpred_tpu_torch.parallel import dp
    import torch.distributed as dist

    batch, keep, lr, k = (inputs[n] for n in ("batch", "keep", "lr", "k"))
    per = batch[0].shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)

    def step(parts, keep_rows, reduce):
        params = seal.init_params(torch.Generator().manual_seed(0),
                                  batch[2].shape[2], k, dev)
        sgd = torch.optim.SGD(seal.leaves(params), lr=lr)
        if reduce:
            dp.reduce_gradients_on_step(sgd, dist.group.WORLD)
        loss = seal.loss_fn(params, *parts[:4], parts[4], k,
                            dropout_rate=0.5,
                            keep=torch.as_tensor(keep_rows, device=dev))
        loss.backward()
        sgd.step()
        return [p.detach() for p in seal.leaves(params)]

    parts = tuple(torch.as_tensor(a[mine], device=dev) for a in batch)
    got = step(parts, keep[mine], True)
    out = {}
    if rank == 0:
        whole = step(tuple(torch.as_tensor(a, device=dev) for a in batch),
                     keep, False)
        for a, b in zip(got, whole):
            torch.testing.assert_close(a, b, **PAR_SEAL_TOL)
        out["max_abs_dparam"] = max(float((a - b).abs().max())
                                    for a, b in zip(got, whole))
    return out


def _rank_device():
    """Every rank's device: card 0, which the ranks share, with the
    switches `cuda_device()` sets (no TF32; cuDNN deterministic, without
    benchmarking)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda", 0)


def _gloo_rates(dev, reps=5):
    """Host-clock ms of the world's all-gather of 4 and 16 MB a rank (bf16)
    and all-reduce of 8 and 32 MB (f32) on `dev`'s tensors: what the
    sharded steps pay for each collective."""
    import torch.distributed as dist

    from linkpred_tpu_torch.parallel.collectives import all_gather_single

    out = {}
    for mb in (4, 16):
        x = torch.ones((mb * 2**20 // 256, 128), dtype=torch.bfloat16,
                       device=dev)
        buf = x.new_empty((dist.get_world_size() * x.shape[0], 128))
        y = torch.ones((mb * 2**18 // 128 * 2, 128), device=dev)
        for name, fn in ((f"all_gather {mb} MB a rank bf16",
                          lambda: all_gather_single(buf, x)),
                         (f"all_reduce {2 * mb} MB f32",
                          lambda: dist.all_reduce(y))):
            fn()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(dev)
            out[name] = (time.perf_counter() - t0) / reps * 1e3
    return out


def par_job_a(rank, world, inputs, save_dir):
    """Job A of the parallel group, on every rank: the probe, par_ops,
    par_twowl, par_seal and the dry run, each timed on the host clock."""
    import torch.distributed as dist

    from linkpred_tpu_torch.graft_entry import dryrun_multichip
    from linkpred_tpu_torch.parallel import collectives as C
    from linkpred_tpu_torch.parallel import make_mesh

    dev = _rank_device()
    out, seconds = {}, {}
    t0 = time.perf_counter()
    out["probe"] = C.probe(dist.group.WORLD, dev)
    mesh = make_mesh(world, shape=(1, world), device_type=dev.type)
    out["mesh_backends"] = {d: dist.get_backend(mesh.get_group(d))
                            for d in mesh.mesh_dim_names}
    out["gloo_ms"] = _gloo_rates(dev)
    seconds["probe"] = time.perf_counter() - t0
    for name, fn in (
            ("ops", lambda: par_ops_rank(rank, world, dev,
                                         mesh.get_group("edge"),
                                         inputs["ops"], save_dir)),
            ("twowl", lambda: par_twowl_rank(rank, world, dev, mesh,
                                             inputs["twowl"])),
            ("seal", lambda: par_seal_rank(rank, world, dev,
                                           inputs["seal"]))):
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        dryrun_multichip(world, device=dev)
    out["dryrun"] = printed.getvalue().splitlines()
    seconds["dryrun"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def _train_counted(gs, hk, cfg, mesh, dev, built, params=None):
    """`train_sharded` with the kernels' counts (and K3's by width) zeroed
    just before and read just after."""
    for counts in (hk.LAUNCHES, hk.LAUNCHES_BY_WIDTH):
        for k in counts:
            counts[k] = 0
    res, local, losses = gs.train_sharded(cfg, mesh, dev, built, params)
    torch.cuda.synchronize(dev)
    return res, local, losses, dict(hk.LAUNCHES, **hk.LAUNCHES_BY_WIDTH)


def par_job_b(rank, world, cfgs, builts, params_np):
    """Job B of the parallel group, on every rank: `train_sharded` at the
    full config, node-sharded then halo, each counted (`_train_counted`);
    the weights' largest difference across ranks. Then the repeat: each
    layout cut to `PAR_REPEAT_STEPS` steps, twice from the same
    parameters. Returns (the runs, each layout's two runs' losses)."""
    import torch.distributed as dist

    from linkpred_tpu_torch.ops import hopper_kernels as hk
    from linkpred_tpu_torch.parallel import collectives as C
    from linkpred_tpu_torch.parallel import make_mesh
    from linkpred_tpu_torch.pipelines import gcn_scale as gs

    dev = _rank_device()
    mesh = make_mesh(world, shape=(1, world), device_type=dev.type)
    runs = []
    for cfg, built, p_np in zip(cfgs, builts, params_np):
        res, local, losses, counts = _train_counted(
            gs, hk, cfg, mesh, dev, built, gs.params_from_jax(p_np, dev))
        res["max_param_spread"] = C.max_spread(
            [local[k] for k in ("w1", "w1s", "w2", "w2s")],
            mesh.get_group("edge"))
        runs.append((res, losses, counts))
        dist.barrier()
    repeats = []
    for built, p_np in zip(builts, params_np):
        short = dict(built, cfg=dataclasses.replace(built["cfg"],
                                                    steps=PAR_REPEAT_STEPS))
        t0 = time.perf_counter()
        losses = [gs.train_sharded(short["cfg"], mesh, dev, short,
                                   gs.params_from_jax(p_np, dev))[2]
                  for _ in range(2)]
        repeats.append((losses, time.perf_counter() - t0))
        dist.barrier()
    return runs, repeats


def _one_rank_n2v(n2v, dev):
    """`train_sgns_mesh` over a one-rank ("data",) mesh against the
    one-shard replay, and the routed walk over a one-rank ("edge",) mesh,
    in a world of one rank (`n2v`: the graph, its one-shard layout, a
    corpus and an SGNS config)."""
    from linkpred_tpu_torch.parallel import make_mesh
    from linkpred_tpu_torch.parallel.sgns import (train_sgns_mesh,
                                                  train_sgns_mesh_reference)

    g, layout, corpus, cfg = n2v
    out = {}
    t0 = time.perf_counter()
    emb = train_sgns_mesh(PAR_N2V_SEED, corpus, g.num_nodes, cfg,
                          mesh=make_mesh(1, shape=(1,), axis_names=("data",),
                                         device_type=dev.type))
    out["sgns_seconds"] = time.perf_counter() - t0
    ref = train_sgns_mesh_reference(PAR_N2V_SEED, corpus, g.num_nodes, cfg,
                                    n_shards=1, device=dev)
    out["sgns_max_abs_diff"] = float(np.abs(emb - ref).max())
    walks, out["walks_lost"] = layout.walks(
        make_mesh(1, shape=(1,), axis_names=("edge",), device_type=dev.type),
        PAR_N2V_SEED, 10, 16)
    out["walks_valid"] = _valid_on_card(walks, g, dev)
    return out


def par_nccl_rank(port, cfgs, builts, n2v, out_path):
    """par_nccl's second process: rank 0 of a one-rank NCCL job joined as
    `torchrun` would start it (`parallel.distributed.initialize` from the
    environment), so that every collective of `train_sharded` runs on NCCL
    once: the probe's list; the host builds (`build_sharded`, one shard,
    node-sharded and halo) broadcast from rank 0 by `broadcast_object_list`
    as `train_sharded` sends its own (they come from the parent, which
    holds the problem: a build here would cost ~25 s); then `train_sharded`
    over a (1, 1) mesh on each (the halo run's all-to-all); then
    `train_sgns_mesh` over a one-rank ("data",) mesh against the one-shard
    replay, and the routed walk over a one-rank ("edge",) mesh (`n2v`: the
    fb graph, its one-shard layout, a corpus and an SGNS config)."""
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch.distributed as dist

    from linkpred_tpu_torch.ops import hopper_kernels as hk
    from linkpred_tpu_torch.parallel import collectives as C
    from linkpred_tpu_torch.parallel import distributed, make_mesh
    from linkpred_tpu_torch.pipelines import gcn_scale as gs

    assert distributed.initialize()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"backend": dist.get_backend(),
           "probe": C.probe(dist.group.WORLD, dev)}
    mesh = make_mesh(1, shape=(1, 1), device_type="cuda")
    out["mesh_backends"] = {d: dist.get_backend(mesh.get_group(d))
                            for d in mesh.mesh_dim_names}
    box = [builts]
    dist.broadcast_object_list(box, src=0)
    out["runs"] = [_train_counted(gs, hk, cfg, mesh, dev, built)[::3]
                   for cfg, built in zip(cfgs, box[0])]
    out.update(_one_rank_n2v(n2v, dev))
    distributed.finish()
    with open(out_path, "w") as f:
        json.dump(out, f)


def parallel_phases(dev, hk, problem=None, walk_rates=None):
    """The parallel group: the multi-GPU stack (`linkpred_tpu_torch.
    parallel`) as four gloo ranks that share the one card (NCCL refuses two
    ranks on one card; gloo moves CUDA tensors through the host). Job A:
    par_probe, par_ops, par_twowl, par_seal, par_dryrun; the parent then
    times K3 (at both widths), K2 and K1 on rank 0's operands (four
    processes on one card make any in-rank timing meaningless); job B:
    par_collab; job C: dn_walks and dn_sgns, the distributed node2vec; then
    par_nccl: the torchrun command at world size 1 on NCCL, and
    `train_sharded`, `train_sgns_mesh` and the routed walk over a one-rank
    NCCL mesh. `walk_rates`: phase (t)'s one-card hops/s, printed beside
    dn_walks'. Returns the kernel rows' numbers."""
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.ops import spmm
    from linkpred_tpu_torch.parallel import multihost
    from linkpred_tpu_torch.parallel.halo import HaloLayout
    from linkpred_tpu_torch.pipelines import gcn_scale as gs
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp

    t_group = time.perf_counter()
    cfg = gs.ScaleGCNConfig(steps=60, learning_rate=3e-3)
    cfg_halo = dataclasses.replace(cfg, aggregation="halo")
    t0 = time.perf_counter()
    if problem is None:
        problem = gs.build_problem(cfg)
    build_seconds = time.perf_counter() - t0
    built_ns = gs.build_sharded(cfg, PAR_RANKS, problem)
    built_halo = gs.build_sharded(cfg_halo, PAR_RANKS, problem)
    lay = built_halo["layout"]
    # par_ops' second halo layout: the other hub rule on a cheap ordering
    t0 = time.perf_counter()
    other = HaloLayout.build(problem[0], PAR_RANKS, reorder="balance",
                             hub_min_refs=None if lay.num_hubs else 3)
    other_seconds = time.perf_counter() - t0
    whole = spmm.BucketedEll.from_graph(problem[0]).operands("cpu")
    phase("par_build", label=PAR_LABEL, nodes=cfg.nodes,
          build_seconds=build_seconds if build_seconds > 1 else
          "reused the gcn group's",
          layout_seconds={"node_sharded": built_ns["layout_seconds"],
                          "halo": built_halo["layout_seconds"],
                          "halo other hub rule": other_seconds},
          rows_per_shard=built_ns["rows_per_shard"],
          halo={n: {"ghost_capacity": l_.ghost_capacity,
                    "edge_cut": l_.edge_cut, "num_hubs": l_.num_hubs,
                    "hub_capacity": l_.hub_capacity,
                    "collective_bytes_per_layer_f128_bf16":
                        l_.collective_bytes_per_layer(128, 2)}
                for n, l_ in (("train", lay), ("other", other))})

    run = tp.TwoWLRunConfig(epochs=5)
    edges, num_nodes = tp.load_edges()
    data = tp.build_data(edges, num_nodes, run, np.random.default_rng(0))
    twowl_cfg = m.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell",
                              dp_emb=0.0, dp_1wl0=0.0, dp_1wl1=0.0,
                              dp_2wl=0.0)
    rng = np.random.default_rng(0)
    B, K, F = 64, 60, 40
    adj = (rng.random((B, K, K)) < 0.1).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.transpose(0, 2, 1)
    a_tilde = adj + np.eye(K, dtype=np.float32)[None]
    pairs = gs.batch_schedule(cfg, problem[1])[0]
    inputs = {
        "ops": {"nodes": cfg.nodes, "ns": built_ns,
                "halo": {"train": lay, "other": other},
                "whole_ops": tuple(a.numpy() if torch.is_tensor(a) else a
                                   for a in whole),
                "pairs": pairs},
        "twowl": {"data": data, "cfg": twowl_cfg,
                  "batches": tp.batch_schedule(data, run)},
        "seal": {"batch": ((1.0 / a_tilde.sum(axis=2)).astype(np.float32),
                           a_tilde, rng.standard_normal((B, K, F)).astype(
                               np.float32), np.ones((B, K), bool),
                           rng.integers(0, 2, B).astype(np.int64)),
                 "keep": rng.random((B, 128)) < 0.5, "lr": 0.05, "k": 30},
    }
    save_dir = tempfile.mkdtemp(prefix="par_ops_")
    t0 = time.perf_counter()
    job_a = multihost.launch(par_job_a, PAR_RANKS, save_dir,
                             args=(inputs, save_dir), timeout_s=600,
                             threads=2)
    job_a_seconds = time.perf_counter() - t0
    first = job_a[0]
    phase("par_probe", collectives=first["probe"],
          mesh_backends=first["mesh_backends"], gloo_ms=first["gloo_ms"],
          all_ok=all(v == "ok" for v in first["probe"].values()))
    assert first["mesh_backends"] == {"data": "gloo", "edge": "gloo"}
    assert all(v == "ok" for r in job_a for v in r["probe"].values())
    ops_err = {}
    for r in job_a:
        for k, v in r["ops"][0].items():
            ops_err[k] = max(ops_err.get(k, 0.0), v)
    k3_launches = [r["ops"][1] for r in job_a]
    assert all(n > 0 for n in k3_launches), k3_launches
    phase("par_ops", max_abs_err_over_ranks=ops_err,
          k3_launches_per_rank=k3_launches,
          seconds_per_rank=[r["seconds"]["ops"] for r in job_a])
    tw = [r["twowl"] for r in job_a]
    assert all(t["sgd_max_abs_dparam"] < PAR_SGD_TOL for t in tw), tw
    assert tw[0]["sgd_spread"] <= PAR_SPREAD_BOUND, tw[0]
    assert tw[0]["trial_loss_max_rel_diff"] <= PAR_TRIAL_LOSS_RTOL, tw[0]
    assert tw[0]["trial_auc_max_abs_diff"] <= PAR_TRIAL_AUC_ATOL, tw[0]
    assert [t["trials_here"] for t in tw] == [32 // PAR_RANKS] * PAR_RANKS
    twowl_launches = {k: sum(t["launches"][k] for t in tw)
                      for k in tw[0]["launches"]}
    assert twowl_launches["spmm_ell"] > 0 \
        and twowl_launches["spmm_bucketed"] > 0, twowl_launches
    phase("par_twowl", sgd_max_abs_dparam=[t["sgd_max_abs_dparam"]
                                           for t in tw],
          sgd_spread_bound=PAR_SPREAD_BOUND, sgd_spread=tw[0]["sgd_spread"],
          trial_loss_max_rel_diff=tw[0]["trial_loss_max_rel_diff"],
          trial_auc_max_abs_diff=tw[0]["trial_auc_max_abs_diff"],
          mean_val_auc_last_epoch=tw[0]["mean_val_auc_last_epoch"],
          sweep_launches_summed_over_ranks=twowl_launches,
          k1_err=max(t["k1_err"] for t in tw),
          seconds_per_rank=[r["seconds"]["twowl"] for r in job_a])
    phase("par_seal", max_abs_dparam=job_a[0]["seal"]["max_abs_dparam"],
          tol=PAR_SEAL_TOL,
          seconds_per_rank=[r["seconds"]["seal"] for r in job_a])
    phase("par_dryrun", printed=first["dryrun"],
          seconds_per_rank=[r["seconds"]["dryrun"] for r in job_a],
          job_seconds=job_a_seconds)
    assert first["dryrun"][-1] == "dryrun_multichip OK", first["dryrun"]
    assert first["dryrun"][-2].startswith("distributed sgns step"), \
        first["dryrun"]

    # the timings, in this process, on rank 0's operands
    saved = torch.load(os.path.join(save_dir, "rank0_operands.pt"))
    shutil.rmtree(save_dir, ignore_errors=True)
    times = {}
    for name in ("node_sharded", "halo"):
        for f in PAR_WIDTHS:
            x, ops = saved[f"{name} F={f}"]
            x = x.to(dev)
            ops = tuple(a.to(dev) if torch.is_tensor(a) else a for a in ops)
            library, reason = library_spmm(
                lambda: bucketed_csr(*ops, x.shape[0], dtype=torch.bfloat16),
                x, hk.spmm_bucketed(x, *ops))
            times[f"{name} F={f}"] = report(
                time_in_turns(lambda: hk.spmm_bucketed_reference(x, *ops),
                              lambda: hk.spmm_bucketed(x, *ops)),
                spmm_bucketed_work(x, *ops), hk, dev, library, reason)
            phase("par_ops_time", kernel="K3", path=name, x=list(x.shape),
                  device_kernel=device_kernels(
                      lambda: hk.spmm_bucketed(x, *ops)),
                  output_rows=int(ops[0].shape[0]),
                  slots=int(ops[2].shape[0]), **times[f"{name} F={f}"])
    src, dst, table = (a.to(dev) for a in saved["sddmm"])
    library, reason = library_sddmm(src, dst, table, table,
                                    hk.sddmm(src, dst, table, table))
    times["sddmm"] = report(
        time_in_turns(lambda: hk.sddmm_reference(src, dst, table, table),
                      lambda: hk.sddmm(src, dst, table, table)),
        sddmm_work(src, dst, table, table), hk, dev, library, reason)
    phase("par_ops_time", kernel="K2", path="gcn sharded scoring",
          pairs=int(src.shape[0]), table=list(table.shape), **times["sddmm"],
          device_kernel=device_kernels(
              lambda: hk.sddmm(src, dst, table, table)))
    cot = torch.randn(src.shape[0], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    order = hk.incidence_order(src, dst)
    expect = hk.sddmm_grad(cot, src, dst, table, None, order)[0]
    library, reason = library_spmm(
        lambda: sddmm_grad_csr(cot, src, dst, table.shape[0], table.dtype),
        table, expect)
    times["sddmm_grad"] = report(
        time_in_turns(
            lambda: hk.sddmm_grad_reference(cot, src, dst, table),
            lambda: hk.sddmm_grad(cot, src, dst, table, None, order)),
        sddmm_grad_work(cot, src, dst, table), hk, dev, library, reason)
    times["sddmm_grad"].update(
        parent_ms=kernel_ms(lambda: parent_gradient(cot, src, dst, table)),
        with_order_ms=kernel_ms(lambda: hk.sddmm_grad(cot, src, dst, table)))
    phase("par_ops_time", kernel="K2 gradient", path="gcn sharded scoring",
          pairs=int(src.shape[0]), table=list(table.shape),
          **times["sddmm_grad"])
    trn = m.SplitArrays.from_split(data.train, dev)
    x1 = _par_x(int(trn.num_msg), 8 * twowl_cfg.channels_1wl, torch.float32,
                4).to(dev)
    slots, weight = trn.msg_slots, trn.msg_sweight
    library, reason = library_spmm(
        lambda: ell_csr(slots, weight, x1.shape[0]), x1,
        hk.spmm_ell(slots, weight, x1))
    times["spmm_ell"] = report(
        time_in_turns(lambda: hk.spmm_ell_reference(slots, weight, x1),
                      lambda: hk.spmm_ell(slots, weight, x1)),
        spmm_ell_work(slots, weight, x1), hk, dev, library, reason)
    phase("par_ops_time", kernel="K1", path="twowl trial-sharded (8 of 32 "
          "trials a rank)", nbr=list(slots.shape), x=list(x1.shape),
          **times["spmm_ell"],
          device_kernel=device_kernels(lambda: hk.spmm_ell(slots, weight, x1)))
    out = {"ops_err": ops_err, "times": times,
           "twowl_launches": twowl_launches,
           "k1_err": max(t["k1_err"] for t in tw)}
    out["collab"] = _par_collab(dev, cfg, cfg_halo, problem, built_ns,
                                built_halo)
    _par_n2v(dev, problem, walk_rates or {})
    _par_nccl(cfg, cfg_halo, problem)
    phase("par_group", seconds=time.perf_counter() - t_group)
    return out


def _par_collab(dev, cfg, cfg_halo, problem, built_ns, built_halo):
    """par_collab: `train_collab` at the full config over the four ranks,
    node-sharded and halo, from the seeded parameters (a halo run renames
    the nodes, its embedding rows and every pair with them), held to the
    one-rank run of its first steps. Returns each run's launches summed
    over the ranks."""
    from linkpred_tpu_torch.ops import spmm
    from linkpred_tpu_torch.parallel import multihost
    from linkpred_tpu_torch.pipelines import gcn_scale as gs

    p0 = gs.init_params(cfg, torch.Generator().manual_seed(cfg.seed), "cpu")
    p_np = {k: v.detach().numpy() for k, v in p0.items()}
    t0 = time.perf_counter()
    job_b = multihost.launch(par_job_b, PAR_RANKS,
                             tempfile.mkdtemp(prefix="par_collab_"),
                             args=([cfg, cfg_halo], [built_ns, built_halo],
                                   [p_np, p_np]),
                             timeout_s=900, threads=2)
    job_b_seconds = time.perf_counter() - t0
    repeats = job_b[0][1]  # rank 0's
    job_b = [r[0] for r in job_b]
    # the one-rank run of the first steps, from the same parameters and
    # batches
    ops_whole = spmm.BucketedEll.from_graph(problem[0]).operands(dev)
    batches = gs.batch_schedule(cfg, problem[1])
    collab = {}
    for i, name in enumerate(("node_sharded", "halo")):
        res, losses, _ = job_b[0][i]
        counts = {k: sum(r[i][2].get(k, 0) for r in job_b)
                  for k in job_b[0][i][2]}
        per_rank = [r[i][2]["spmm_bucketed"] for r in job_b]
        params = gs.params_from_jax(p_np, dev)
        ref = gs.train_steps(
            params, gs.adam(params, cfg.learning_rate),
            torch.as_tensor(batches[:PAR_LOSS_STEPS].astype(np.int32),
                            device=dev), ops_whole, cfg).cpu().numpy()
        loss_diff = float(np.abs(losses[:PAR_LOSS_STEPS] - ref).max())
        spread = max(r[i][0]["max_param_spread"] for r in job_b)
        assert loss_diff <= PAR_LOSS_ATOL, (name, loss_diff)
        assert spread <= PAR_SPREAD_BOUND, (name, spread)
        assert res["loss_decreased"], res
        assert res["test_auc"] >= GCN_AUC_FLOOR, res
        assert all(n > 0 for n in per_rank) and counts["sddmm"] > 0, counts
        assert counts["sddmm_grad"] > 0, counts
        assert all(counts.get(f"spmm_bucketed F={f}", 0) > 0
                   for f in PAR_WIDTHS), counts
        assert res["aggregation"] == name, res
        collab[name] = counts
        phase("par_collab", label=PAR_LABEL,
              ranks=PAR_RANKS, launches_summed_over_ranks=counts,
              k3_launches_per_rank=per_rank,
              first_losses=[float(v) for v in losses[:PAR_LOSS_STEPS]],
              one_rank_first_losses=[float(v) for v in ref],
              max_abs_loss_diff=loss_diff, loss_tol=PAR_LOSS_ATOL,
              spread_bound=PAR_SPREAD_BOUND,
              **dict(res, max_param_spread=spread))
    # (par_collab_repeat) each layout cut to PAR_REPEAT_STEPS steps, run
    # twice in job B from the same parameters: rank 0's losses
    for name, (runs, seconds) in zip(("node_sharded", "halo"), repeats):
        repeat_phase("par_collab_repeat", lambda: runs[1],
                     lambda losses: {"losses": losses}, first=runs[0],
                     seconds=seconds, label=PAR_LABEL, aggregation=name,
                     steps=PAR_REPEAT_STEPS)
    phase("par_collab_job", seconds=job_b_seconds)
    return collab


def par_job_c(rank, world, inputs):
    """Job C of the parallel group, on every rank: the distributed node2vec.
    dn_walks: the routed walk of each layout in `inputs["routed"]` (rank k
    loads only its shard k from the file the parent wrote) and
    `sharded_walks` on fb-pages-food; dn_sgns: `train_sgns_mesh` at the
    logistic family's config on the fb corpus, then at phase (u)'s shape.
    Each timed on the host clock after an untimed warm-up. Rank 0 returns
    the walk matrices and tables; every rank a digest of each."""
    import hashlib
    import pickle

    from linkpred_tpu_torch.models.word2vec import SGNSConfig
    from linkpred_tpu_torch.ops.walk import WalkEngine
    from linkpred_tpu_torch.parallel import make_mesh
    from linkpred_tpu_torch.parallel.sgns import train_sgns_mesh
    from linkpred_tpu_torch.parallel.walks import sharded_walks
    from linkpred_tpu_torch.pipelines.logistic_pipeline import LogisticConfig

    dev = _rank_device()
    edge = make_mesh(world, shape=(world,), axis_names=("edge",),
                     device_type=dev.type)
    data = make_mesh(world, shape=(world,), axis_names=("data",),
                     device_type=dev.type)
    out, seconds, digest, lost, walks = {}, {}, {}, {}, {}

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        arr = res[0] if isinstance(res, tuple) else res
        digest[name] = hashlib.sha1(arr.tobytes()).hexdigest()
        if rank == 0:
            out[name] = arr
        return res

    fb = inputs["fb"]
    eng = WalkEngine(fb, device=dev)
    sharded_walks(data, eng, 0, 1, 4)  # warm-up: kernels and both groups
    loaded = None
    for name, path, num_walks, length, cap in inputs["routed"]:
        if path != loaded:  # a layout's runs follow each other
            with open(path.format(rank), "rb") as f:
                shard = pickle.load(f)
            shard.walks(edge, 0, 1, 2)  # warm-up at this layout
            loaded = path
        walks[name], lost[name] = timed(name, lambda: shard.walks(
            edge, PAR_N2V_SEED, num_walks, length, capacity_per_dest=cap))
    del shard
    timed("fb sharded_walks", lambda: sharded_walks(
        data, eng, PAR_N2V_SEED, 50, 16).cpu().numpy())
    # dn_sgns on the routed fb corpus, which every rank holds whole (the
    # digests show it is one matrix)
    corpus = walks["fb p=q=1"]
    timed("sgns fb", lambda: train_sgns_mesh(
        PAR_N2V_SEED, corpus, fb.num_nodes, LogisticConfig().embed,
        mesh=data))
    big = np.random.default_rng(5).integers(
        0, inputs["collab_nodes"], (65_536, 16), dtype=np.int32)
    timed("sgns collab", lambda: train_sgns_mesh(
        PAR_N2V_SEED, big, inputs["collab_nodes"],
        SGNSConfig(dim=128, epochs=1, batch_size=65_536), mesh=data))
    # the repeat: the same table trained twice from one seed on the first
    # rows of the corpus (20 steps)
    t0 = time.perf_counter()
    tables = [train_sgns_mesh(
        PAR_N2V_SEED, big[:PAR_REPEAT_SGNS_ROWS], inputs["collab_nodes"],
        SGNSConfig(dim=128, epochs=1, batch_size=65_536), mesh=data)
        for _ in range(2)]
    seconds["sgns repeat"] = time.perf_counter() - t0
    if rank == 0:
        out["sgns repeat"] = tables
    return {"out": out, "seconds": seconds, "digest": digest, "lost": lost}


def _cond_freq(walks, n):
    """Row-normalised counts of the moves a -> b (a != b) of `walks`."""
    a, b = walks[:, :-1].reshape(-1), walks[:, 1:].reshape(-1)
    moved = a != b
    c = np.zeros((n, n))
    np.add.at(c, (a[moved], b[moved]), 1)
    return c / np.maximum(c.sum(axis=1, keepdims=True), 1)


def _valid_on_card(walks, g, dev, starts=None):
    """`walks_are_valid` against `g`'s ELL rows, on the card; row r starts
    at node r % N unless `starts` says otherwise."""
    import types

    eng = types.SimpleNamespace(nbr=torch.as_tensor(g.nbr, device=dev),
                                degree=torch.as_tensor(g.degree, device=dev))
    if starts is None:
        starts = np.arange(len(walks)) % g.num_nodes
    return walks_are_valid(torch.as_tensor(walks, device=dev),
                           torch.as_tensor(starts, device=dev), eng)


def _logistic_auc(emb, dev, seed=35):
    """The logistic family's test AUC from embeddings `emb` [620, dim]:
    `run_logistic`'s pairs, features, split and fit at `seed`, composed
    from the port's functions."""
    from linkpred_tpu_torch.data import io as dio
    from linkpred_tpu_torch.data import split as sp
    from linkpred_tpu_torch.models.logistic import fit_logistic, predict_proba
    from linkpred_tpu_torch.ops.sddmm import edge_sum
    from linkpred_tpu_torch.utils import metrics

    g, edges = dio.load_fb_pages_food()
    neg = sp.reference_scan_negatives(edges, g.num_nodes)
    pos = edges[sp.removable_positive_edges(edges, g.num_nodes)]
    pairs = torch.as_tensor(np.concatenate([pos, neg]), dtype=torch.long,
                            device=dev)
    y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    x = edge_sum(pairs[:, 0], pairs[:, 1], torch.as_tensor(emb, device=dev))
    trn, tst = sp.train_test_split_arrays(len(y), 0.3,
                                          np.random.default_rng(seed))
    beta = fit_logistic(x[torch.as_tensor(trn, device=dev)],
                        torch.as_tensor(y[trn], dtype=torch.float32,
                                        device=dev),
                        class_weight="balanced", device=dev)
    scores = predict_proba(beta, x[torch.as_tensor(tst, device=dev)])
    return float(metrics.roc_auc_score(y[tst], scores.cpu().numpy()))


def _fb_residual():
    """fb-pages-food less its removable edges: the logistic family's walk
    graph."""
    from linkpred_tpu_torch.data import io as dio
    from linkpred_tpu_torch.data import split as sp
    from linkpred_tpu_torch.data.graph import Graph

    g, edges = dio.load_fb_pages_food()
    keep = np.setdiff1d(np.arange(len(edges)), sp.removable_positive_edges(
        edges, g.num_nodes))
    return Graph.from_undirected_edges(edges[keep, 0], edges[keep, 1],
                                       num_nodes=g.num_nodes)


def _par_n2v(dev, problem, walk_rates):
    """dn_walks and dn_sgns: the distributed node2vec over the four ranks
    (job C), held in this process to `WalkEngine.walks` on the card (hop
    frequencies) and to `train_sgns_mesh_reference` (the table), with the
    logistic family's AUC from the mesh embeddings."""
    import pickle

    from linkpred_tpu_torch.models.word2vec import SGNSConfig
    from linkpred_tpu_torch.ops.walk import WalkEngine
    from linkpred_tpu_torch.parallel import multihost
    from linkpred_tpu_torch.parallel.sgns import (_cap_batch,
                                                  _shard_geometry,
                                                  train_sgns_mesh_reference)
    from linkpred_tpu_torch.parallel.walks import TableShardedWalker
    from linkpred_tpu_torch.pipelines.logistic_pipeline import LogisticConfig

    t_all = time.perf_counter()
    fb = _fb_residual()
    collab = dataclasses.replace(problem[0], nbr_weight=None)
    workdir = tempfile.mkdtemp(prefix="par_n2v_")
    default_cap = 4 * (-(-collab.num_nodes // PAR_RANKS) // PAR_RANKS) + 16
    runs = (("fb p=q=1", fb, (1.0, 1.0), 50, None),
            ("fb p=2 q=0.5", fb, (2.0, 0.5), 50, None),
            ("collab", collab, (1.0, 1.0), 1,
             PAR_COLLAB_CAP_FACTOR * default_cap))
    routed, layouts = [], {}
    for name, g, pq, num_walks, cap in runs:
        t0 = time.perf_counter()
        lay = TableShardedWalker.build(g, PAR_RANKS, *pq)
        build_s = time.perf_counter() - t0
        path = os.path.join(workdir, name.replace(" ", "_") + ".{}.pkl")
        for k in range(PAR_RANKS):
            with open(path.format(k), "wb") as f:
                pickle.dump(lay.shard(k), f, protocol=pickle.HIGHEST_PROTOCOL)
        layouts[name] = {"build_seconds": build_s,
                         "write_seconds": time.perf_counter() - t0 - build_s,
                         "rows_per_shard": lay.rows,
                         "edge_rows_per_shard": int(lay.rev_next.shape[1]),
                         "shard_mb": os.path.getsize(path.format(0)) / 2**20}
        routed.append((name, path, num_walks, 16, cap))
        del lay
    # the collab walk once more at the reference's default capacity
    routed.append(("collab default capacity", path, 1, 16, None))
    t0 = time.perf_counter()
    job_c = multihost.launch(
        par_job_c, PAR_RANKS, workdir,
        args=({"fb": fb, "routed": routed,
               "collab_nodes": collab.num_nodes},), timeout_s=900, threads=1)
    job_seconds = time.perf_counter() - t0
    shutil.rmtree(workdir, ignore_errors=True)
    first = job_c[0]
    for r in job_c[1:]:  # the ranks hold one result
        assert r["digest"] == first["digest"], (r["digest"], first["digest"])
    secs = {k: max(r["seconds"][k] for r in job_c) for k in first["seconds"]}

    # dn_walks
    gen = torch.Generator(device=dev).manual_seed(PAR_N2V_SEED)
    freq_diff = {}
    for name, g, pq, num_walks, cap in runs:
        walks = first["out"][name]
        assert walks.shape == (num_walks * g.num_nodes, 16), walks.shape
        assert all(r["lost"][name] == 0 for r in job_c), name
        assert _valid_on_card(walks, g, dev), name
        if name.startswith("fb"):
            eng = WalkEngine(g, *pq, device=dev)
            ref = eng.walks(gen, num_walks, 16).cpu().numpy()
            freq_diff[name] = float(np.abs(
                _cond_freq(walks, g.num_nodes)
                - _cond_freq(ref, g.num_nodes)).max())
            assert freq_diff[name] < PAR_FREQ_ATOL, (name, freq_diff[name])
        hops = num_walks * g.num_nodes * 15
        phase("dn_walks", label=PAR_LABEL, graph=name, p=pq[0], q=pq[1],
              nodes=g.num_nodes, walkers=num_walks * g.num_nodes, length=16,
              lost=[r["lost"][name] for r in job_c],
              max_cond_freq_diff=freq_diff.get(name), tol=PAR_FREQ_ATOL,
              seconds=secs[name], hops_per_s=hops / secs[name],
              one_card_hops_per_s_phase_t=walk_rates.get(
                  "collab" if name == "collab" else "fb",
                  "not run (group n2v)") if pq == (1.0, 1.0) else None,
              capacity_per_dest=cap or "default", layout=layouts[name])
    walks = first["out"]["collab default capacity"]
    back = ~(walks == 0).all(axis=1)  # node 0 has neighbours: a row of
    assert collab.degree[0] > 0  # zeros is a lost walker
    assert first["lost"]["collab default capacity"] == int((~back).sum())
    assert _valid_on_card(walks[back], collab, dev, starts=np.flatnonzero(
        back) % collab.num_nodes)
    phase("dn_walks", label=PAR_LABEL, graph="collab",
          capacity_per_dest=default_cap, gated=False,
          lost=first["lost"]["collab default capacity"],
          lost_share=first["lost"]["collab default capacity"]
          / collab.num_nodes, seconds=secs["collab default capacity"])
    walks = first["out"]["fb sharded_walks"]
    assert walks.shape == (50 * fb.num_nodes, 16)
    assert _valid_on_card(walks, fb, dev)
    eng = WalkEngine(fb, device=dev)
    ref = eng.walks(gen, 50, 16).cpu().numpy()
    fd = float(np.abs(_cond_freq(walks, fb.num_nodes)
                      - _cond_freq(ref, fb.num_nodes)).max())
    assert fd < PAR_FREQ_ATOL, fd
    eng.walks(gen, 50, 16)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.walks(gen, 50, 16)
    torch.cuda.synchronize(dev)
    one_card = time.perf_counter() - t0
    phase("dn_walks", label=PAR_LABEL, graph="fb p=q=1 sharded_walks",
          walkers=len(walks), max_cond_freq_diff=fd, tol=PAR_FREQ_ATOL,
          seconds=secs["fb sharded_walks"],
          hops_per_s=len(walks) * 15 / secs["fb sharded_walks"],
          one_card_seconds=one_card,
          one_card_hops_per_s=len(walks) * 15 / one_card)

    # dn_sgns
    big = np.random.default_rng(5).integers(0, collab.num_nodes,
                                            (65_536, 16), dtype=np.int32)
    for name, corpus, n, cfg in (
            ("sgns fb", first["out"]["fb p=q=1"], fb.num_nodes,
             LogisticConfig().embed),
            ("sgns collab", big, collab.num_nodes,
             SGNSConfig(dim=128, epochs=1, batch_size=65_536))):
        t0 = time.perf_counter()
        ref = train_sgns_mesh_reference(PAR_N2V_SEED, corpus, n, cfg,
                                        n_shards=PAR_RANKS, device=dev)
        replay = time.perf_counter() - t0
        got = first["out"][name]
        assert got.shape == (n, cfg.dim) and np.isfinite(got).all()
        err = float(np.abs(got - ref).max())
        np.testing.assert_allclose(got, ref, **PAR_SGNS_TOL)
        capped = _cap_batch(cfg, n)
        nc, bc = _shard_geometry(capped, PAR_RANKS)
        steps = max(int(cfg.epochs * corpus.size * cfg.window * 2
                        / (bc * nc)), 1)
        extra = {}
        if name == "sgns fb":
            extra["test_auc_seed35"] = _logistic_auc(got, dev)
            assert extra["test_auc_seed35"] >= LOGISTIC_AUC_FLOOR, extra
        phase("dn_sgns", label=PAR_LABEL, corpus=list(corpus.shape),
              table=[n, cfg.dim], steps=steps, centers_per_step=bc,
              ctx_per_center=nc, pool=cfg.neg_pool,
              max_abs_diff_vs_replay=err, tol=PAR_SGNS_TOL,
              seconds=secs[name], steps_per_s=steps / secs[name],
              replay_seconds_one_process=replay,
              score_all_reduce_bytes_per_step=bc * (nc + cfg.neg_pool) * 4,
              index_gather_bytes_per_step=bc * (1 + 2 * nc) * 4,
              auc_floor=LOGISTIC_AUC_FLOOR if extra else None, **extra)
    # (dn_sgns_repeat) job C's two runs of `train_sgns_mesh` from one
    # seed: rank 0's gathered table
    tables = first["out"]["sgns repeat"]
    repeat_phase("dn_sgns_repeat", lambda: tables[1],
                 lambda table: {"table": table}, first=tables[0],
                 seconds=secs["sgns repeat"], label=PAR_LABEL,
                 corpus=[PAR_REPEAT_SGNS_ROWS, 16],
                 table=[collab.num_nodes, 128])
    phase("dn_job", seconds=job_seconds,
          seconds_all=time.perf_counter() - t_all)


def _par_nccl(cfg, cfg_halo, problem):
    """par_nccl: the command a multi-card user runs, here at world size 1
    (one rank takes the one-card path), then `train_sharded` over a
    one-rank NCCL mesh (`par_nccl_rank`), whose node-sharded run is held to
    the command's one-card run of the same 8 steps."""
    import multiprocessing
    import socket

    from linkpred_tpu_torch.models.word2vec import SGNSConfig
    from linkpred_tpu_torch.parallel.walks import TableShardedWalker
    from linkpred_tpu_torch.pipelines import gcn_scale as gs

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "linkpred_tpu_torch.cli", "scale",
         "--family", "gcn", "--steps", "8"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["steps"] == 8 and res["shards"] == 1, res
    assert np.isfinite(res["loss_first_quarter"])
    phase("par_nccl", world_size=1, backend="nccl", rc=proc.returncode,
          seconds=time.perf_counter() - t0, **res)

    # the CLI's config at 8 steps, over a one-rank mesh
    t0 = time.perf_counter()
    cfgs = [dataclasses.replace(gs.ScaleGCNConfig(), steps=8)]
    cfgs.append(dataclasses.replace(cfgs[0], aggregation="halo"))
    builts = [gs.build_sharded(c, 1, problem) for c in cfgs]
    fb = _fb_residual()
    n2v = (fb, TableShardedWalker.build(fb, 1),
           np.random.default_rng(6).integers(0, fb.num_nodes, (6_200, 16),
                                             dtype=np.int32),
           SGNSConfig(dim=100, epochs=1))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_path = os.path.join(tempfile.mkdtemp(prefix="par_nccl_"), "out.json")
    child = multiprocessing.get_context("spawn").Process(
        target=par_nccl_rank, args=(port, cfgs, builts, n2v, out_path))
    child.start()
    child.join(300)
    if child.exitcode is None:
        child.terminate()
        child.join(10)
    assert child.exitcode == 0, child.exitcode
    with open(out_path) as f:
        got = json.load(f)
    assert got["backend"] == "nccl", got["backend"]
    assert got["mesh_backends"] == {"data": "nccl", "edge": "nccl"}, got
    assert all(v == "ok" for v in got["probe"].values()), got["probe"]
    (ns, ns_counts), (halo, halo_counts) = got["runs"]
    for k in ("loss_first_quarter", "loss_last_quarter"):
        assert abs(ns[k] - res[k]) <= PAR_LOSS_ATOL, (k, ns[k], res[k])
    assert ns["shards"] == halo["shards"] == 1
    assert np.isfinite([halo["loss_first_quarter"], halo["test_auc"]]).all()
    assert min(ns_counts["spmm_bucketed"], halo_counts["spmm_bucketed"],
               ns_counts["sddmm"], halo_counts["sddmm"]) > 0
    assert got["sgns_max_abs_diff"] <= PAR_NCCL_SGNS_TOL, got
    assert got["walks_lost"] == 0 and got["walks_valid"], got
    phase("par_nccl_mesh", world_size=1, backend=got["backend"],
          mesh_backends=got["mesh_backends"], collectives=got["probe"],
          seconds=time.perf_counter() - t0,
          node_sharded=dict(ns, launches=ns_counts),
          one_card_loss_quarters=[res["loss_first_quarter"],
                                  res["loss_last_quarter"]],
          loss_tol=PAR_LOSS_ATOL, halo=dict(halo, launches=halo_counts),
          sgns_max_abs_diff_vs_one_shard_replay=got["sgns_max_abs_diff"],
          sgns_tol=PAR_NCCL_SGNS_TOL, sgns_seconds=got["sgns_seconds"],
          routed_walks_lost=got["walks_lost"])


def slice_phases(dev, hk, data, run, trn, rates):
    """(c)-(f): TwoWL on fb-pages-food, one trial. Returns K1's largest
    error against its plain version."""
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp

    # (c) K1 against spmm_ell_reference on the card: slice shapes + ragged
    tst = m.SplitArrays.from_split(data.test, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def feats(rows, f):
        return torch.randn((rows, f), generator=gen, device=dev)

    def ragged(m_, d_, nx, f, zero_every=3):
        nbr = torch.randint(-2, nx + 3, (m_, d_), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.randn((m_, d_), generator=gen, device=dev)
        w[::zero_every] = 0.0
        return nbr, w, feats(nx, f)

    cases = {
        "train[620,114]x24": (trn.msg_slots, trn.msg_sweight,
                              feats(trn.num_msg, 24)),
        "train[620,114]x16": (trn.msg_slots, trn.msg_sweight,
                              feats(trn.num_msg, 16)),
        "test[620,120]x24": (tst.msg_slots, tst.msg_sweight,
                             feats(tst.num_msg, 24)),
        "train x64": (trn.msg_slots, trn.msg_sweight,
                      feats(trn.num_msg, 64)),
        "ragged D=1 F=7": ragged(40, 1, 30, 7),
        "ragged F=33": ragged(25, 6, 11, 33),
        "ragged F=1": ragged(12, 4, 5, 1),
        "empty rows D=120": ragged(64, 120, 3765, 24, zero_every=1),
    }
    max_err = 0.0
    for name, args in cases.items():
        got = hk.spmm_ell(*args)
        torch.cuda.synchronize()
        ref = hk.spmm_ell_reference(*args)
        err = float((got - ref).abs().max())
        assert torch.isfinite(got).all() and got.shape == ref.shape, name
        assert err <= K1_TOL, (name, err)
        max_err = max(max_err, err)
        phase("c_k1_check", case=name, shape=[list(a.shape) for a in args],
              max_abs_err=err)
    timing = {}
    for name in ("train[620,114]x24", "train[620,114]x16"):
        args = cases[name]
        library, reason = library_spmm(
            lambda: ell_csr(*args[:2], args[2].shape[0]), args[2],
            hk.spmm_ell(*args))
        f = args[2].shape[1]
        timing[name] = report(
            time_in_turns(lambda: hk.spmm_ell_reference(*args),
                          lambda: hk.spmm_ell(*args)),
            spmm_ell_work(*args), hk, dev, library, reason,
            launches_per_epoch=rates["slice"].get(f"spmm_ell F={f}", 0))
        phase("c_k1_time", case=name, **timing[name],
              device_kernel=device_kernels(lambda: hk.spmm_ell(*args)))

    # (d) kernel path against plain path: published-best architecture,
    # dropouts 0, same init. lr 1e-3: at 1e-2 Adam turns the f32-noise
    # gradients of the GraphNorm-cancelled conv biases into lr-size steps
    # and two correct aggregations drift apart by ~1e-2 in 20 epochs.
    E_d = 20
    cfg_d = m.TwoWLConfig(max_degree=data.max_degree, dp_emb=0.0,
                          dp_1wl0=0.0, dp_1wl1=0.0, dp_2wl=0.0,
                          learning_rate=1e-3)
    run_d = dataclasses.replace(run, epochs=E_d)
    # `LAUNCHES` counts the host's launches, and an epoch replayed from the
    # loop's CUDA graph makes none: the kernels the card ran are counted
    # from a device trace of each run
    res_d = {}
    for agg in ("plan", "ell"):
        before, epochs = dict(hk.LAUNCHES), dict(m.EPOCH_COUNTS)
        ran = traced_kernels(lambda: res_d.update({agg: tp.train_routine_fused(
            data, dataclasses.replace(cfg_d, agg_1wl=agg), run_d, dev)}))
        res_d[agg]["launches"] = {k: hk.LAUNCHES[k] - before[k]
                                  for k in before}
        res_d[agg]["epochs"] = {k: m.EPOCH_COUNTS[k] - epochs[k]
                                for k in epochs}
        res_d[agg]["ran"] = wrapper_kernels(ran)
    l_plan, l_ell = res_d["plan"]["loss_history"], res_d["ell"]["loss_history"]
    assert np.isfinite(l_ell).all() and np.isfinite(l_plan).all()
    np.testing.assert_allclose(l_ell, l_plan, rtol=LOSS_RTOL)
    # 'plan' runs no K1 or K3; both aggregations gather on the row gather
    plan_launches, plan_ran = res_d["plan"]["launches"], res_d["plan"]["ran"]
    assert plan_launches.pop("gather_rows") > 0, plan_launches
    assert plan_ran.pop("gather_rows") > 0, plan_ran
    assert set(plan_launches.values()) == {0}, plan_launches
    assert set(plan_ran.values()) == {0}, plan_ran
    ran_d, epochs_d = res_d["ell"]["ran"], res_d["ell"]["epochs"]
    assert epochs_d["eager"] + epochs_d["replayed"] == E_d, epochs_d
    assert ran_d["spmm_ell"] >= 2 * cfg_d.depth1 * E_d, ran_d
    assert ran_d["spmm_bucketed"] >= 2 * (1 + cfg_d.depth2) * E_d, ran_d
    phase("d_ell_vs_plan", epochs=E_d,
          max_rel_loss_diff=float(np.max(np.abs(l_ell - l_plan)
                                         / np.abs(l_plan))),
          best_val={a: r["best_val"] for a, r in res_d.items()},
          launches_ell=res_d["ell"]["launches"], ran_ell=ran_d,
          epochs_ell=epochs_d)

    # (e) the slice: 200 epochs, reference dropouts, the 1-WL aggregation on
    # K1 and the 2-WL one on K3. The launch counts are zeroed just before
    # and read just after this run.
    E_e = 200
    cfg_e = m.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell")
    run_e = dataclasses.replace(run, epochs=E_e)
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    res_e = tp.train_routine_fused(data, cfg_e, run_e, dev)
    launches_e = dict(hk.LAUNCHES)
    assert np.isfinite(res_e["loss_history"]).all()
    assert res_e["history"].shape == (E_e,)
    assert res_e["best_val"] >= VAL_AUC_FLOOR, res_e["best_val"]
    assert 0.0 <= res_e["test_auc"] <= 1.0
    assert launches_e["spmm_ell"] > 0 and launches_e["spmm_bucketed"] > 0, \
        f"K1 or K3 never launched: {launches_e}"
    # the same run on the plain aggregation, in turns (ell, plan, plan, ell)
    # so both see the same warm card and host
    turns = [res_e] + [tp.train_routine_fused(
        data, dataclasses.replace(cfg_e, agg_1wl=agg), run_e, dev)
        for agg in ("plan", "plan", "ell")]
    rate = [E_e / r["train_seconds"] for r in turns]
    # a torch.profiler trace of 10 epochs of each after 2 untraced
    pos_e, neg_e = (torch.as_tensor(a, dtype=torch.long, device=dev)
                    for a in tp.batch_schedule(data, run_e))
    loop_inputs = (trn, m.SplitArrays.from_split(data.val, dev),
                   torch.as_tensor(data.val.y, device=dev),
                   tp.node_features(cfg_e, data, dev))
    profiles = {}
    for agg in ("ell", "plan"):
        c = dataclasses.replace(cfg_e, agg_1wl=agg)
        p = m.init_params(c, torch.Generator().manual_seed(0), dev)
        opt = m.adam(p, c.learning_rate)
        g = torch.Generator(device=dev).manual_seed(1)
        # one best for all calls, so the traced epochs are replays
        best = (m.tree_map(lambda t: t.detach().clone(), p), 0.0)
        profiles[agg] = step_profile(
            lambda a, b: m.train_loop(p, opt, g, pos_e[a:b], neg_e[a:b],
                                      *loop_inputs, c, data.num_nodes,
                                      init_best=best))
    phase("e_slice", epochs=E_e, best_val=res_e["best_val"],
          test_auc=res_e["test_auc"], launches=launches_e,
          epochs_per_s=(rate[0] + rate[3]) / 2,
          plan_epochs_per_s=(rate[1] + rate[2]) / 2,
          epochs_per_s_ell_plan_plan_ell=rate,
          plan_best_val=turns[1]["best_val"],
          plan_test_auc=turns[1]["test_auc"],
          busy_share=busy_shares(profiles, rate), profile=profiles)
    # (e_repeat) the slice cut to 50 epochs, twice from one seed
    repeat_phase(
        "e_slice_repeat", lambda: tp.train_routine_fused(
            data, cfg_e, dataclasses.replace(run, epochs=REPEAT_SLICE_EPOCHS),
            dev),
        lambda r: {"losses": r["loss_history"], "val_aucs": r["history"],
                   "test_auc": r["test_auc"]},
        epochs=REPEAT_SLICE_EPOCHS)

    # (f) the entry point, every output under a temporary directory
    with tempfile.TemporaryDirectory() as tmp:
        before = hk.LAUNCHES["spmm_ell"]
        res_f = tp.run_twowl(
            dataclasses.replace(run, epochs=50,
                                records_dir=os.path.join(tmp, "records")),
            n_trials=1, device=dev, verbose=False,
            log_file=os.path.join(tmp, "logs.json"),
            state_file=os.path.join(tmp, "state.jsonl"), roc_dir=tmp,
            metrics_file=os.path.join(tmp, "metrics.jsonl"), roc_png=None,
            checkpoint_path=os.path.join(tmp, "ckpt", "model"))
        rec = os.path.join(tmp, "records", "fb-pages-food_auc_record_twowl.txt")
        with open(rec) as f:
            lines = f.read().splitlines()
        assert len(lines) == 1 and lines[0].startswith("AUC:"), lines
        for name in ("logs.json", "fpr.json", "tpr.json", "metrics.jsonl",
                     "ckpt/model.npz", "ckpt/model.tree.json"):
            assert os.path.getsize(os.path.join(tmp, name)) > 0, name
        assert 0.0 <= res_f["test_auc"] <= 1.0
        assert hk.LAUNCHES["spmm_ell"] > before
        phase("f_run_twowl", trials=1, epochs=50, best_val=res_f["best_val"],
              test_auc=res_f["test_auc"], hp=res_f["best_params"],
              launches=hk.LAUNCHES["spmm_ell"] - before,
              record=lines[0])

    return max_err


def launch_shapes(fn):
    """(kernel name, grid, block, launches) of the device kernels one call
    of `fn` runs, from the chrome trace of a torch.profiler capture: how a
    kernel was launched, as the trace records it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    shapes = {}
    for e in events:
        if e.get("cat") == "kernel":
            key = (kernel_name(e["name"]), str(e["args"].get("grid")),
                   str(e["args"].get("block")))
            shapes[key] = shapes.get(key, 0) + 1
    return [[*k, n] for k, n in sorted(shapes.items())]


def gather_work(x, idx, y=None, j=None):
    """(bytes, flops) of `gather_rows(x, idx, y, j)`: the output and the
    indices once, and each table row an index names once (`y`'s own rows
    whole when `j` is None; a row both `idx` and `j` name, when `y` is
    `x`, once); one multiply an element with `y`."""
    row = x.shape[1] * x.element_size()
    nbytes = idx.numel() * (row + 8)

    def named(t, *index):
        i = torch.cat(index)
        return int(torch.unique(i[i < t.shape[0]]).numel()) * row

    if y is None:
        nbytes += named(x, idx)
    elif j is None:
        nbytes += named(x, idx) + y.numel() * y.element_size()
    elif y is x:
        nbytes += j.numel() * 8 + named(x, idx, j)
    else:
        nbytes += j.numel() * 8 + named(x, idx) + named(y, j)
    flops = 0 if y is None else idx.numel() * x.shape[1]
    return nbytes, flops


def scale_cell_loop(dev, epochs):
    """`loop(a, b)` as `single_trial_loop`, on the twowl-50k.train cell's
    settings: `run_twowl_scale`'s data and widths at a val pass every
    epoch and a constant lr (`ScaleTwoWLConfig(eval_every=1,
    warmup_epochs=0)`), 'ell', from a random node table (node2vec's
    seeding changes no shape)."""
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp
    from linkpred_tpu_torch.pipelines import twowl_scale as ts

    cfg = ts.ScaleTwoWLConfig(eval_every=1, warmup_epochs=0, epochs=epochs)
    data = ts.build_scale_data(cfg)
    trn, val = ts.split_operands(data, dev)
    mcfg = ts.model_config(cfg, data, "ell")
    p = m.init_params(mcfg, torch.Generator().manual_seed(0), dev)
    opt = m.adam(p, mcfg.learning_rate)
    pos_e, neg_e = (torch.as_tensor(a, dtype=torch.long, device=dev)
                    for a in ts.batch_schedule(cfg, data))
    inputs = (trn, val, torch.as_tensor(data.val.y, device=dev),
              tp.node_features(mcfg, data, dev))
    best = (m.tree_map(lambda t: t.detach().clone(), p), 0.0)

    def loop(a, b):
        m.train_loop(p, opt, None, pos_e[a:b], neg_e[a:b], *inputs, mcfg,
                     data.num_nodes, early_stop=None, eval_every=1,
                     init_best=best)

    return loop


def epoch_gathers(loop, hk, replays=5):
    """The row gathers of one replayed epoch of `loop`'s main path:
    (shape -> launches an epoch, as the capture called
    `hopper_kernels.gather_rows`; the gather kernels that a device trace
    of `replays` replays ran, launches and device ms an epoch). A shape is
    (table rows, width, dtype, rows gathered, second operand: None, "rows"
    for y's own rows, or "gathered" for x's rows named by j)."""
    from linkpred_tpu_torch.models import twowl as m

    calls, real = {}, hk.gather_rows

    def spy(x, idx, y=None, j=None):
        assert y is None or j is None or y is x, "a second table"
        second = None if y is None else "rows" if j is None else "gathered"
        key = (x.shape[0], x.shape[1], x.dtype, idx.shape[0], second)
        calls[key] = calls.get(key, 0) + 1
        return real(x, idx, y, j)

    loop(0, 1)  # the optimizer's first epoch, op by op
    epochs = dict(m.EPOCH_COUNTS)
    with mock.patch.object(hk, "gather_rows", spy):
        loop(1, 2)  # the epoch's capture, then its first replay
    assert {k: v - epochs[k] for k, v in m.EPOCH_COUNTS.items()} == {
        "eager": 0, "replayed": 1, "captures": 1}
    readings = []
    for _ in range(3):  # a capture may lose events: at most three
        us = [t for name, t in traced_events(lambda: loop(2, 2 + replays))
              if name.startswith("gather_rows")]
        readings.append({"launches": len(us) / replays,
                         "device_ms": sum(us) / 1e3 / replays})
        if readings[-1]["launches"] == sum(calls.values()):
            return calls, readings[-1]
    raise AssertionError(f"replayed epochs ran {readings} gather kernels, "
                         f"the capture called {calls}")


def gather_phases(dev, hk, data, cfg, run):
    """The row gather (`csrc/gather_rows.cu`) on both cells' main paths:
    the gathers that a replayed epoch of twowl-50k.train's loop and of
    fb-pages-food's single-trial loop call, counted at their capture, and
    the gather kernels' launches and device ms in a trace of the replays.
    Then each shape they called: bit for bit the plain version (twice),
    timed in turns against it beside its bound and PyTorch's own call
    (`x[idx]`; for the edge product the parent's three launches `x[src] *
    x[dst]`; for a gradient term the parent's multiply of the saved
    gathered rows), and both kernels' launch shapes. Returns the rows of
    the kernels line."""
    from linkpred_tpu_torch.ops import sddmm as sd

    loops = {"50k": lambda: scale_cell_loop(dev, 7),
             "fb": lambda: single_trial_loop(dev, data, cfg, run, 7)}
    epoch, rows_out = {}, []
    for cell, make in loops.items():
        calls, traced = epoch_gathers(make(), hk)
        timed_ms = 0.0
        for seed, ((n, f, dtype, count, second), launches) in enumerate(
                sorted(calls.items(), key=str)):
            name = (f"{cell} [{n}, {f}] {str(dtype).split('.')[-1]} "
                    f"rows={count} {second or 'gather'}")
            rng = np.random.default_rng(seed)
            x = torch.from_numpy(rng.standard_normal((n, f)).astype(
                np.float32)).to(dev, dtype)
            idx = torch.from_numpy(rng.integers(0, n, count)).to(dev)
            ops = [x, idx]
            if second == "gathered":
                j = torch.from_numpy(rng.integers(0, n, count)).to(dev)
                ops += [x, j]
                library = lambda: x[idx] * x[j]  # noqa: E731
                kind = "parent x[src] * x[dst] (three launches)"
            elif second == "rows":
                g = torch.from_numpy(rng.standard_normal((count, f)).astype(
                    np.float32)).to(dev, dtype)
                ops.append(g)
                xd = x[idx]
                library = lambda: g * xd  # noqa: E731
                kind = "parent g * saved x[dst] (one multiply, no gather)"
            else:
                library = lambda: x[idx]  # noqa: E731
                kind = "x[idx]"
            before = hk.LAUNCHES["gather_rows"]
            got, again = hk.gather_rows(*ops), hk.gather_rows(*ops)
            want = hk.gather_rows_reference(*ops)
            torch.cuda.synchronize()
            assert hk.LAUNCHES["gather_rows"] == before + 2, name
            assert torch.equal(got, want) and torch.equal(got, again), name
            assert torch.equal(got, library()), name
            times = report(
                time_in_turns(lambda: hk.gather_rows_reference(*ops),
                              lambda: hk.gather_rows(*ops)),
                gather_work(*ops), hk, dev, library)
            timed_ms += times["ms"] * launches
            phase("gather_rows", shape=name, x=[n, f], dtype=str(dtype),
                  rows=count, second=second, bitwise_equal=True,
                  launches_per_epoch=launches, library_call=kind,
                  kernel_launch=launch_shapes(lambda: hk.gather_rows(*ops)),
                  library_launch=launch_shapes(library), **times)
            rows_out.append((name, launches, times))
            del x, idx, ops, got, again, want
        epoch[cell] = {"launches": sum(calls.values()),
                       "traced": traced, "timed_ms": timed_ms}
    # the edge product's backward at the 50k train shape: the two fused
    # terms and their row sums, bit for bit autograd's
    src, dst = (torch.from_numpy(np.random.default_rng(s).integers(
        0, 50000, 703916)).to(dev) for s in (1, 2))
    x = torch.randn((50000, 16), device=dev)
    g = torch.randn((703916, 16), device=dev)
    grads = []
    for fn in (lambda t: sd.edge_hadamard(src, dst, t),
               lambda t: t[src] * t[dst]):
        t = x.clone().requires_grad_()
        fn(t).backward(g)
        grads.append(t.grad)
    assert torch.equal(*grads)
    phase("gather_rows_epoch", per_epoch=epoch,
          hadamard_backward_bitwise_equal=True)
    return rows_out


GROUPS = ("slice", "gcn", "sweep", "n2v", "scale", "seal", "surface",
          "parallel", "gather")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default=",".join(GROUPS),
                        help="comma-separated groups of phases to run: "
                             + ", ".join(GROUPS))
    only = parser.parse_args().only.split(",")
    assert set(only) <= set(GROUPS), only
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    from linkpred_tpu_torch import native
    from linkpred_tpu_torch.kernels import build
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.ops import hopper_kernels as hk
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp
    from linkpred_tpu_torch.utils.device import cuda_device

    # (a) device
    dev = cuda_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    phase("a_device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    # (b) build K1, K3, K2 and the empty kernel (the floor under a kernel's
    # time) from the sources in this checkout, one nvcc per source, all at
    # once
    kernel_names = ("spmm_ell", "spmm_bucketed", "sddmm", "gather_rows",
                    "empty_launch")
    t0 = time.perf_counter()
    build.libraries(kernel_names)
    phase("b_build", kernels=kernel_names, nvcc=build.nvcc_path(),
          flags=" ".join(build.NVCC_FLAGS),
          libraries=[str(build.library_path(k).relative_to(os.getcwd()))
                     for k in kernel_names],
          seconds=round(time.perf_counter() - t0, 3))
    for k in kernel_names:
        for line in build.BUILD_LOGS.get(k, "").splitlines():
            print(f"  nvcc {k}: {line}")

    # the slice's data; the host negative sampler's C++ library is built by
    # the data module on first use (numpy sampler when that build fails)
    run = tp.TwoWLRunConfig()
    edges, num_nodes = tp.load_edges()
    data = tp.build_data(edges, num_nodes, run, np.random.default_rng(0))
    phase("data", nodes=num_nodes, max_degree=data.max_degree,
          msg_train=data.train.num_msg, rows_test=data.test.num_rows,
          negative_sampler="c++" if native.available() else "numpy",
          native_host_lib=str(native.library_path().relative_to(
              os.getcwd())))

    # the launches one epoch adds, by kernel and width: the single-trial
    # loop and the trial-major sweep, both on K1 and K3
    cfg_ell = m.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell")
    rates = {}
    if {"slice", "sweep"} & set(only):
        rates["slice"], ran = graph_launch_rates(dev, hk, data, cfg_ell, run)
        assert ran["spmm_ell"] >= 2 * cfg_ell.depth1, ran
        assert ran["spmm_bucketed"] >= 2 * (1 + cfg_ell.depth2), ran
        rates["sweep"] = launch_rates(lambda n: tp.refine_vmapped(
            data, cfg_ell, dataclasses.replace(run, epochs=n),
            n_trials=SWEEP_TRIALS, device=dev), hk)
        phase("launch_rates", launches_per_epoch=rates,
              slice_replayed_kernels_per_epoch=ran)
    trn = m.SplitArrays.from_split(data.train, dev)
    gather = gather_phases(dev, hk, data, cfg_ell, run) \
        if "gather" in only else None

    max_err = slice_phases(dev, hk, data, run, trn, rates) \
        if "slice" in only else None
    gcn = gcn_phases(dev, hk) if "gcn" in only else None
    sweep = sweep_phases(dev, hk, data, run, trn, rates) \
        if "sweep" in only else None
    walk_rates = {}
    if "n2v" in only:
        if gcn is None:
            from linkpred_tpu_torch.pipelines import gcn_scale as gs

            collab = gs.build_problem(gs.ScaleGCNConfig())[0]
        else:
            collab = gcn.pop("graph")
        walk_rates = n2v_phases(dev, collab)
        del collab
    scale = scale_phases(dev, hk) if "scale" in only else None
    if "seal" in only:
        seal_phases(dev, hk)
    if "surface" in only:
        surface_phases(dev, hk)
    par = parallel_phases(dev, hk, gcn and gcn.pop("problem"), walk_rates) \
        if "parallel" in only else None
    if set(only) != set(GROUPS):
        print(json.dumps({"partial": only}))
        return

    def row(name, path, source, replaces, launches, err, times):
        return {"name": name, "route": "cuda", "path": path,
                "source": f"linkpred_tpu_torch/csrc/{source}",
                "replaces": (f"linkpred_tpu/ops/pallas_kernels.py:{replaces}"
                             if replaces else "no TPU kernel: a row gather "
                             "the JAX package leaves to XLA"),
                "launches": launches, "max_abs_err": err, "ms": times["ms"],
                "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
                "bound_by": times["bound_by"],
                "library_ms": times["library_ms"],
                "estimated_readings": times["estimated_readings"]}

    # one row per kernel and main path: K1 and K3 with the sweep's launches
    # (phase p) and their times at its shapes (phases n, m), and with the
    # 50k-node run's (phase w) and their times at its shapes (phase x; K3's
    # error there is its bf16 one, a bf16 ulp of sums up to ~15 rows); K2
    # with the collab run's (phase j); then rows by width
    print(json.dumps({"kernels": [
        row("spmm_ell", "twowl sweep", "spmm_ell.cu", 68,
            sweep["launches"]["spmm_ell"], max(max_err, sweep["k1_err"]),
            sweep["k1_times"][24 * SWEEP_TRIALS]),
        row("spmm_bucketed", "twowl sweep", "spmm_bucketed.cu", 249,
            sweep["launches"]["spmm_bucketed"],
            max(gcn["k3_err"], sweep["k3_err"]),
            sweep["k3_times"][32 * SWEEP_TRIALS]),
        row("sddmm", "gcn collab", "sddmm.cu", 144, gcn["launches"]["sddmm"],
            gcn["k2_err"], gcn["k2_time"]),
        # K2's gradient (the reference's autodiff of the TPU kernel's
        # gathers), with the collab run's launches and its step's time
        row("sddmm_grad", "gcn collab backward", "sddmm.cu", 144,
            gcn["launches"]["sddmm_grad"], gcn["k2g_err"], gcn["k2g_time"]),
        # K3 at the GCN's two widths, each with its width's launches in
        # the collab run (phase j) and its time on that layout (phase h)
        *[row("spmm_bucketed", f"gcn collab F={f} bf16", "spmm_bucketed.cu",
              249, gcn["by_width"][f"spmm_bucketed F={f}"], gcn["k3_err"],
              gcn["k3_time"][f]) for f in (64, 128)],
        row("spmm_ell", "twowl scale", "spmm_ell.cu", 68,
            scale["launches"]["spmm_ell"], scale["k1_err"],
            scale["k1_times"][24]),
        row("spmm_bucketed", "twowl scale", "spmm_bucketed.cu", 249,
            scale["launches"]["spmm_bucketed"], scale["k3_err"]["bf16"],
            scale["k3_times"]["scale fwd F=32 bfloat16"]),
        # the narrow shapes, each with its width's launches in the main
        # run: K3's degree pass at F = 1 (the slot kernel) and K1's other
        # widths (F = 16 at 50k nodes: the packed kernel)
        row("spmm_bucketed", "twowl sweep F=1 f32", "spmm_bucketed.cu", 249,
            sweep["by_width"]["spmm_bucketed F=1"], sweep["k3_err"],
            sweep["k3_times"][1]),
        row("spmm_ell", f"twowl sweep F={16 * SWEEP_TRIALS}", "spmm_ell.cu",
            68, sweep["by_width"][f"spmm_ell F={16 * SWEEP_TRIALS}"],
            sweep["k1_err"], sweep["k1_times"][16 * SWEEP_TRIALS]),
        row("spmm_bucketed", "twowl scale bwd F=32 bf16", "spmm_bucketed.cu",
            249, scale["by_width"]["spmm_bucketed F=32"],
            scale["k3_err"]["bf16"],
            scale["k3_times"]["scale bwd F=32 bfloat16"]),
        row("spmm_bucketed", "twowl scale F=1 f32", "spmm_bucketed.cu", 249,
            scale["by_width"]["spmm_bucketed F=1"], scale["k3_err"]["f32"],
            scale["k3_times"]["scale fwd F=1 float32"]),
        row("spmm_ell", "twowl scale F=16", "spmm_ell.cu", 68,
            scale["by_width"]["spmm_ell F=16"], scale["k1_err"],
            scale["k1_times"][16]),
        # the parallel group: launches summed over the four ranks of its
        # main paths (par_collab's two runs, par_twowl's trial-sharded
        # sweep), errors the worst of any rank against the plain version
        # (K3: both dtypes at the row's width), times on rank 0's bf16
        # operands; K3 has a row for each width of the GCN's aggregations
        *[row("spmm_bucketed", f"gcn {name} F={f} bf16, 4 gloo ranks",
              "spmm_bucketed.cu", 249,
              par["collab"][name][f"spmm_bucketed F={f}"],
              max(v for k, v in par["ops_err"].items()
                  if k.startswith(prefixes) and f" F={f} " in k),
              par["times"][f"{name} F={f}"])
          for name, prefixes in (
              ("node_sharded", ("node_sharded", "pipelined")),
              ("halo", ("halo",)))
          for f in PAR_WIDTHS],
        row("sddmm", "gcn node_sharded and halo, 4 gloo ranks", "sddmm.cu",
            144, par["collab"]["node_sharded"]["sddmm"]
            + par["collab"]["halo"]["sddmm"],
            max(v for k, v in par["ops_err"].items()
                if k.startswith("sddmm ")), par["times"]["sddmm"]),
        row("sddmm_grad", "gcn node_sharded and halo backward, 4 gloo ranks",
            "sddmm.cu", 144, par["collab"]["node_sharded"]["sddmm_grad"]
            + par["collab"]["halo"]["sddmm_grad"],
            max(v for k, v in par["ops_err"].items()
                if k.startswith("sddmm_grad")), par["times"]["sddmm_grad"]),
        row("spmm_ell", "twowl trial-sharded, 4 gloo ranks", "spmm_ell.cu", 68,
            par["twowl_launches"]["spmm_ell"], par["k1_err"],
            par["times"]["spmm_ell"]),
        # the row gather at each shape a replayed epoch of the two cells'
        # loops called, bit for bit the plain version (error 0), with the
        # launches an epoch that the capture made at that shape
        *[row("gather_rows", f"twowl epoch {name}", "gather_rows.cu", None,
              launches, 0.0, times) for name, launches, times in gather],
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
