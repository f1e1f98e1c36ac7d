"""The port's own spans (`linkpred_tpu_torch/utils/profiling.py`: the TwoWL
epoch loops' `twowl.*`, the kernel loader's `kernels.*`) as per-layer
numbers of a cell, in three parts:

(a) set-up: spans recorded from before the driver's build to the end of its
    start (the checked epochs and the warm chunk): `kernels.load`, with any
    `kernels.compile` inside, and the first `twowl.epoch`;
(b) a stretch: `STRETCH_STEPS` epochs in one call of the window's loop with
    recording on and no profiler, then a synchronize: each phase's host
    time, and the epochs' intervals on the card's clock (`mark_step`);
(c) a capture of `steps` epochs (`trace._capture`, the host's events kept)
    with recording on: each idle gap of the card is put down to the
    innermost port span covering its midpoint.

`begin`/`end` bracket (a); `collect` runs (b), then (c), and belongs
before any other profiler capture of the process, since a capture with the
card's activity slows the rest of its process. Recording is off outside
these parts. The readers in `metrics/` read what `collect` returns as
`ctx.spans`. A traced run of `run.py` (`harness.run_cell`) makes (a) and
(b) and skips (c), which no reader reads; the tool below makes all three.

    python3 hbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs one cell as `run.py` does, with (a) around its set-up and (b) and (c)
after its window (recording off), and prints one JSON line: the nine span
metrics by their readers, the window's and the stretch's epochs a second
(what recording costs), the idle table and the check. Nothing here runs at
import, and a port without the recorder gives no spans and no error.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

STRETCH_STEPS = 240  # 12 samples beyond the 95th percentile
MIN_TAIL = 200  # a 95th percentile has 10 samples or more beyond it
PREFIXES = ("twowl.", "kernels.")
PHASES = ("twowl.inputs", "twowl.forward", "twowl.backward",
          "twowl.optimizer", "twowl.eval")
NO_SPAN = "(no port span)"
# the metrics read from `ctx.spans`, with their units
METRICS = {"host_ms.epochs": "ms", "forward_ms.epochs": "ms",
           "backward_ms.epochs": "ms", "optimizer_ms.epochs": "ms",
           "eval_ms.epochs": "ms", "epoch_ms_p50.epochs": "ms",
           "epoch_ms_p95.epochs": "ms", "kernel_load_s.setup": "s",
           "first_epoch_s.setup": "s"}


def _profiling():
    """The port's recorder, or None where the port has none."""
    try:
        from linkpred_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "recording") else None


# -- arithmetic ---------------------------------------------------------------


def tail(values) -> tuple[float, float, int] | None:
    """(median, 95th percentile, sample count), the percentile by
    `statistics.quantiles`' default method; None with fewer than
    `MIN_TAIL` samples."""
    if len(values) < MIN_TAIL:
        return None
    return (statistics.median(values),
            statistics.quantiles(values, n=20)[-1], len(values))


def median_ms(spans, name: str, own: bool) -> float | None:
    """Median duration (or, `own`, self time: less the part its children
    cover, `profiling.self_ns`) in ms of the spans `name`."""
    ns = _profiling().self_ns(spans) if own else {
        s.id: s.end_ns - s.start_ns for s in spans}
    values = [ns[s.id] / 1e6 for s in spans if s.name == name]
    return statistics.median(values) if values else None


def idle_by_span(busy: list, ranges: list) -> dict[str, float]:
    """Seconds of the gaps between merged busy intervals `busy` ([start_us,
    end_us], sorted), each put down to the innermost of `ranges` ((name,
    start_us, end_us) of nested host ranges) over the gap's midpoint: the
    one that started last."""
    gaps = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        covering = [r for r in ranges if r[1] <= mid <= r[2]]
        name = (max(covering, key=lambda r: r[1])[0] if covering
                else NO_SPAN)
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


# -- the three parts ----------------------------------------------------------


def begin():
    """Turn recording on for (a); returns what `end` takes (None where the
    port has no recorder)."""
    profiling = _profiling()
    if profiling is None:
        return None
    block = profiling.recording()
    return block, block.__enter__()


def end(handle) -> list | None:
    """Turn (a)'s recording off; its spans, or None."""
    if handle is None:
        return None
    block, record = handle
    block.__exit__(None, None, None)
    return record.spans


def stretch(run, device, steps: int = STRETCH_STEPS) -> dict | None:
    """(b): `steps` epochs in one window call with recording on."""
    from hbench.harness import _sync

    profiling = _profiling()
    if profiling is None:
        return None
    _sync(device)
    t0 = time.perf_counter()
    with profiling.recording() as record:
        run.run_steps(steps)
        _sync(device)
    seconds = time.perf_counter() - t0
    return {"spans": record.spans, "step_ms": record.step_ms(),
            "epochs_per_s": steps / seconds}


def capture(run_steps, steps: int) -> dict | None:
    """(c), on the card: its idle seconds over `steps` epochs by port span,
    with the total; None where no capture kept the steps."""
    from hbench import trace

    profiling = _profiling()
    if profiling is None:
        return None
    with profiling.recording():
        group, host = trace._capture(run_steps, steps, with_host=True)
    if not group:
        return None
    ranges = [h for h in host if h[0].startswith(PREFIXES)]
    gaps = idle_by_span(trace._union(group), ranges)
    return {"steps": steps, "idle_s": sum(gaps.values()), "by_span": gaps}


def collect(run, device, setup, capture_steps: int,
            steps: int = STRETCH_STEPS) -> dict:
    """(b), then (c) unless `capture_steps` is 0, with (a)'s spans: what
    the readers take as `ctx.spans`."""
    return {"setup": setup, "stretch": stretch(run, device, steps),
            "idle": (capture(run.run_steps, capture_steps)
                     if device.type == "cuda" and capture_steps else None)}


# -- what the readers read ----------------------------------------------------


def _part(ctx, part: str):
    spans = getattr(ctx, "spans", None)
    return spans.get(part) if spans else None


def phase_ms(ctx, name: str, own: bool = True) -> float | None:
    """Median self time (or duration) in ms of span `name` in (b)."""
    s = _part(ctx, "stretch")
    return median_ms(s["spans"], name, own) if s else None


def epoch_tail(ctx) -> tuple[float, float, int] | None:
    s = _part(ctx, "stretch")
    return tail(s["step_ms"]) if s else None


def kernel_load_s(ctx) -> float | None:
    spans = _part(ctx, "setup")
    if spans is None:
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name == "kernels.load") / 1e9


def first_epoch_s(ctx) -> float | None:
    epochs = [s for s in _part(ctx, "setup") or [] if s.name == "twowl.epoch"]
    if not epochs:
        return None
    first = min(epochs, key=lambda s: s.start_ns)
    return (first.end_ns - first.start_ns) / 1e9


# -- one run of a cell with spans ---------------------------------------------


def measure_cell(name: str, seed: int, seconds: float, device,
                 steps: int = STRETCH_STEPS, spec: dict | None = None,
                 config_overrides: dict | None = None,
                 traffic_overrides: dict | None = None) -> dict:
    """One run of cell `name` as `harness.run_cell` makes it, with (a)
    around its set-up and, after its window, (b) and (c): the span metrics
    by their readers, the rates, the idle table and the check."""
    import torch

    from hbench import check, harness

    spec = spec or harness.load_spec()
    cell = harness.workload(spec, name)
    config = {**harness.load_data("configs", cell["config"]),
              **(config_overrides or {})}
    traffic = {**harness.load_data("traffic", cell["traffic"]),
               **(traffic_overrides or {})}
    drv = harness.driver(config)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    handle = begin()
    t0 = time.perf_counter()
    built = drv.build(config, traffic, device)
    run = drv.start(built, config, traffic, seed, device)
    harness._sync(device)
    setup = end(handle)
    harness.log(f"build and start {time.perf_counter() - t0:.3f} s, spans "
                "recorded")
    window_steps, window_s = harness.timed_window(run, seconds, device)
    ctx = SimpleNamespace(spans=collect(run, device, setup, drv.TRACE_STEPS,
                                        steps))
    metrics = {}
    for metric, unit in METRICS.items():
        value = harness.reader(metric).read(ctx)
        if value is not None:
            metrics[metric] = {"value": value, "unit": unit}
    rates = {"window_epochs_per_s": window_steps / window_s}
    if ctx.spans["stretch"]:
        rates["stretch_epochs_per_s"] = ctx.spans["stretch"]["epochs_per_s"]
        phases = [phase_ms(ctx, p) for p in PHASES + ("twowl.epoch",)]
        rates["phases_self_sum_ms"] = (sum(phases) if None not in phases
                                       else None)
    samples = epoch_tail(ctx)
    idle = ctx.spans["idle"]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.judge(drv.readings(run),
                         harness.load_data("limits", name))
    return {"correct": all(v <= lim for _, v, lim in checks),
            "metrics": metrics, **rates,
            "epoch_samples": samples[2] if samples else 0,
            "idle": idle, "memory_peak_bytes": peak,
            "checks": {k: {"value": v, "limit": lim}
                       for k, v, lim in checks}}


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from hbench import run as hrun  # puts the toolchains' caches in hbench/

    args = hrun.parse(argv)
    import torch

    if not torch.cuda.is_available():
        return hrun.fail("no CUDA card is visible; the spans' numbers are "
                         "the card's")
    from linkpred_tpu_torch.utils.device import cuda_device

    torch.set_num_threads(2)
    device = cuda_device()
    out = measure_cell(args.workload, args.seed, args.seconds, device)
    from hbench import harness

    out["device"] = {"kind": torch.cuda.get_device_name(device),
                     "power_limit": harness.card_power()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
