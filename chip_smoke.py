#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`linkpred_tpu_torch`) on one card.

    python3 chip_smoke.py

Builds kernel K1 from `linkpred_tpu_torch/csrc/`, holds it against its plain
PyTorch version on the card, and drives the port's main path — TwoWL on
fb-pages-food at the published-best widths — through `train_routine_fused`
and the `run_twowl` entry point. One line per phase; then one JSON line of
kernel results, the card's name and power limit as nvidia-smi gives them,
and last `{"ok": true, "device": {...}}`. Nothing catches a failed phase:
without a card, or without the rest of the repository, it raises and exits
non-zero before printing any result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K1_TOL = 1e-5  # max abs error of K1 against its plain version (f32 sums)
LOSS_RTOL = 1e-3  # 'ell' vs 'plan' loss histories, phase (d)
VAL_AUC_FLOOR = 0.65  # best val AUC after 200 epochs (JAX on CPU: 0.731)


def phase(step, **kv):
    print(json.dumps({"phase": step, **kv}), flush=True)


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


def kernel_ms(fn, iters=50):
    """Mean milliseconds per call that the card spends in the kernels `fn`
    launches (sum of their durations in a torch.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler saw no kernel on the card"
    return sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
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

    # (b) build K1 from the sources in this checkout
    t0 = time.perf_counter()
    build.library("spmm_ell")
    phase("b_build", kernel="spmm_ell", nvcc=build.nvcc_path(),
          flags=" ".join(build.NVCC_FLAGS),
          library=str(build.library_path("spmm_ell").relative_to(os.getcwd())),
          seconds=round(time.perf_counter() - t0, 3))
    for line in build.BUILD_LOGS.get("spmm_ell", "").splitlines():
        print(f"  nvcc: {line}")

    # the slice's data; the host negative sampler's C++ library is built by
    # the data builder on first use (numpy fallback when that build fails)
    run = tp.TwoWLRunConfig()
    edges, num_nodes = tp.load_edges()
    data = tp.build_data(edges, num_nodes, run, np.random.default_rng(0))
    phase("data", nodes=num_nodes, max_degree=data.max_degree,
          msg_train=data.train.num_msg, rows_test=data.test.num_rows,
          native_host_lib=os.path.exists(os.path.join("native",
                                                      "libgraphlib.so")))

    # (c) K1 against spmm_ell_reference on the card: slice shapes + ragged
    trn = m.SplitArrays.from_split(data.train, dev)
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
                              feats(trn.num_msg + 1, 24)),
        "train[620,114]x16": (trn.msg_slots, trn.msg_sweight,
                              feats(trn.num_msg + 1, 16)),
        "test[620,120]x24": (tst.msg_slots, tst.msg_sweight,
                             feats(tst.num_msg + 1, 24)),
        "train x64": (trn.msg_slots, trn.msg_sweight,
                      feats(trn.num_msg + 1, 64)),
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

        def plain():
            return hk.spmm_ell_reference(*args)

        def kernel():
            return hk.spmm_ell(*args)

        # plain, kernel, kernel, plain: both see the same warm card
        dev_ms = [kernel_ms(f) for f in (plain, kernel, kernel, plain)]
        call_ms = [cuda_ms(f) for f in (plain, kernel, kernel, plain)]
        timing[name] = {"ms": (dev_ms[1] + dev_ms[2]) / 2,
                        "plain_ms": (dev_ms[0] + dev_ms[3]) / 2}
        phase("c_k1_time", case=name, **timing[name],
              device_ms_plain_kernel_kernel_plain=dev_ms,
              per_call_ms_plain_kernel_kernel_plain=call_ms)

    # (d) kernel path against plain path: published-best architecture,
    # dropouts 0, same init. lr 1e-3: at 1e-2 Adam turns the f32-noise
    # gradients of the GraphNorm-cancelled conv biases into lr-size steps
    # and two correct aggregations drift apart by ~1e-2 in 20 epochs.
    E_d = 20
    cfg_d = m.TwoWLConfig(max_degree=data.max_degree, dp_emb=0.0,
                          dp_1wl0=0.0, dp_1wl1=0.0, dp_2wl=0.0,
                          learning_rate=1e-3)
    run_d = dataclasses.replace(run, epochs=E_d)
    res_d = {}
    for agg in ("plan", "ell"):
        before = hk.LAUNCHES["spmm_ell"]
        res_d[agg] = tp.train_routine_fused(
            data, dataclasses.replace(cfg_d, agg_1wl=agg), run_d, dev)
        res_d[agg]["launches"] = hk.LAUNCHES["spmm_ell"] - before
    l_plan, l_ell = res_d["plan"]["loss_history"], res_d["ell"]["loss_history"]
    assert np.isfinite(l_ell).all() and np.isfinite(l_plan).all()
    np.testing.assert_allclose(l_ell, l_plan, rtol=LOSS_RTOL)
    assert res_d["plan"]["launches"] == 0
    assert res_d["ell"]["launches"] >= 2 * cfg_d.depth1 * E_d, res_d["ell"]
    phase("d_ell_vs_plan", epochs=E_d,
          max_rel_loss_diff=float(np.max(np.abs(l_ell - l_plan)
                                         / np.abs(l_plan))),
          best_val={a: r["best_val"] for a, r in res_d.items()},
          launches_ell=res_d["ell"]["launches"])

    # (e) the slice: 200 epochs, reference dropouts, 1-WL on K1. The launch
    # counts are zeroed just before and read just after this run.
    E_e = 200
    cfg_e = m.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell")
    run_e = dataclasses.replace(run, epochs=E_e)
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    res_e = tp.train_routine_fused(data, cfg_e, run_e, dev)
    launches = dict(hk.LAUNCHES)
    assert np.isfinite(res_e["loss_history"]).all()
    assert res_e["history"].shape == (E_e,)
    assert res_e["best_val"] >= VAL_AUC_FLOOR, res_e["best_val"]
    assert 0.0 <= res_e["test_auc"] <= 1.0
    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"kernels of the path never launched: {missing}"
    # the same run on the plain aggregation, in turns (ell, plan, plan, ell)
    # so both see the same warm card and host
    turns = [res_e] + [tp.train_routine_fused(
        data, dataclasses.replace(cfg_e, agg_1wl=agg), run_e, dev)
        for agg in ("plan", "plan", "ell")]
    rate = [E_e / r["train_seconds"] for r in turns]
    phase("e_slice", epochs=E_e, best_val=res_e["best_val"],
          test_auc=res_e["test_auc"], launches=launches,
          epochs_per_s=(rate[0] + rate[3]) / 2,
          plan_epochs_per_s=(rate[1] + rate[2]) / 2,
          epochs_per_s_ell_plan_plan_ell=rate,
          plan_best_val=turns[1]["best_val"],
          plan_test_auc=turns[1]["test_auc"])

    # (f) the entry point, every output under a temporary directory
    with tempfile.TemporaryDirectory() as tmp:
        before = hk.LAUNCHES["spmm_ell"]
        res_f = tp.run_twowl(
            dataclasses.replace(run, epochs=50,
                                records_dir=os.path.join(tmp, "records")),
            n_trials=1, device=dev, verbose=False,
            log_file=os.path.join(tmp, "logs.json"),
            state_file=os.path.join(tmp, "state.jsonl"), roc_dir=tmp,
            metrics_file=os.path.join(tmp, "metrics.jsonl"))
        rec = os.path.join(tmp, "records", "fb-pages-food_auc_record_twowl.txt")
        with open(rec) as f:
            lines = f.read().splitlines()
        assert len(lines) == 1 and lines[0].startswith("AUC:"), lines
        for name in ("logs.json", "fpr.json", "tpr.json", "metrics.jsonl"):
            assert os.path.getsize(os.path.join(tmp, name)) > 0, name
        assert 0.0 <= res_f["test_auc"] <= 1.0
        assert hk.LAUNCHES["spmm_ell"] > before
        phase("f_run_twowl", trials=1, epochs=50, best_val=res_f["best_val"],
              test_auc=res_f["test_auc"], hp=res_f["best_params"],
              launches=hk.LAUNCHES["spmm_ell"] - before,
              record=lines[0])

    print(json.dumps({"kernels": [{
        "name": "spmm_ell",
        "route": "cuda",
        "source": "linkpred_tpu_torch/csrc/spmm_ell.cu",
        "replaces": "linkpred_tpu/ops/pallas_kernels.py:68",
        "launches": launches["spmm_ell"],
        "max_abs_err": max_err,
        "ms": timing["train[620,114]x24"]["ms"],
        "plain_ms": timing["train[620,114]x24"]["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
