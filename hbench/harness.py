"""The benchmark's engine, driven by data: `BENCHMARK.json` names the cell,
and the harness finds everything else by name. A new configuration and its
cell are new files and new entries; no file here needs an edit for them:

- `configs/<config>.json`: the sizes as run; it names its driver
  (`"driver"`) and states its precision (`"model"`'s `"dtype"`);
- `drivers/<driver>.py` (only for a new family): `build`, `start` (the
  `Run`: `chunk`, `run_steps`, `rates_of`, `ops`, `flops_per_step`,
  `release`), `readings`, `TRACE_STEPS`, `CONTROL_PRECISION` (the control
  for each precision it runs), and optionally `SPAN_STEPS`;
- `reference/<family>.py` (only for a new family): its plain reference;
- `traffic/<traffic>.json`: the mix's parameters;
- `limits/<workload>.json`: the limit of each number the check compares;
- `small/<workload>.json`: `{"config": {...}, "traffic": {...}}`, the
  top-level keys that the CPU tests replace to run the cell small;
- `metrics/<metric>.py` (or `metrics/<name before the first dot>.py`): the
  reader of each per-layer metric, where no reader exists yet.

In `BENCHMARK.json` a new configuration adds an entry to `configs`, its
cell one to `workloads`, and the cell's name is appended to the `workloads`
list of each end-to-end and per-layer metric it reports (or a new metric
entry lists it).

A run: the driver builds (the port's host build, timed as `build_s`) and
starts the cell from the seed (weights, schedule, the checked first steps,
the warm-up); `setup_s` ends there. The window then calls the driver's
chunk until `seconds` have passed and waits for the card. With `trace` the
run reports the per-layer metrics instead: the port's spans are recorded
over set-up and over a stretch of epochs after the window (`spans.py`, only
in traced runs), then profiler captures and the ops' timings follow. Last
the program's state is freed and the reference judges the checked steps.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HB = Path(__file__).resolve().parent
ROOT = HB.parent
SPEC_FILE = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "linkpred_tpu", "benchmarks",
             "bench")
GIB = 1 << 30


def load_spec(path: Path = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def load_data(kind: str, name: str) -> dict:
    with open(HB / kind / f"{name}.json") as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in spec['workloads']]}")


def reported(metrics: list, cell: str) -> list:
    """The metrics of a list that `cell` reports."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def driver(config: dict):
    return importlib.import_module(f"hbench.drivers.{config['driver']}")


def small(name: str) -> tuple[dict, dict]:
    """The overrides of cell `name`'s configuration and traffic at which
    the CPU tests run it (`small/<workload>.json`)."""
    sizes = load_data("small", name)
    return sizes["config"], sizes["traffic"]


def control_precision(config: dict) -> str:
    """The control of a configuration: the precision below the one it
    states, as its driver names it (`CONTROL_PRECISION`)."""
    dtype = config["model"]["dtype"]
    controls = driver(config).CONTROL_PRECISION
    if dtype not in controls:
        raise KeyError(f"driver {config['driver']!r} names no control for "
                       f"{dtype!r}: {controls}")
    return controls[dtype]


def reader(metric: str):
    """The reader module of a per-layer metric: `metrics/<metric>.py`, else
    `metrics/<metric's name before the first dot>.py`."""
    for stem in (metric, metric.split(".")[0]):
        path = HB / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"hbench.metrics.{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r} "
                            f"under {HB / 'metrics'}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is the JAX stack's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def log(message: str) -> None:
    print(f"hbench: {message}", file=sys.stderr, flush=True)


def card_power() -> str:
    """`nvidia-smi`'s name and power limit of the card, written beside the
    shares of a peak ("not read" where it cannot say)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else "not read"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(run, seconds: float, device) -> tuple[int, float]:
    """Window calls of the driver's chunk until `seconds` have passed on the
    host's clock, then a wait for the card: (steps run, seconds from the
    first call to the end of the wait). The host's seconds of each call are
    logged in quartiles, to tell a slow stretch from a slow run."""
    steps, calls = 0, []
    t0 = now = time.perf_counter()
    while now - t0 < seconds:
        n = run.chunk()
        steps += n
        last, now = now, time.perf_counter()
        calls.append((now - last) / n)
    _sync(device)
    window = time.perf_counter() - t0
    q = statistics.quantiles(calls, n=4) if len(calls) > 1 else calls * 3
    log(f"window: host ms a step by call, quartiles "
        f"{' '.join(f'{1e3 * v:.3f}' for v in q)}, min {1e3 * min(calls):.3f}"
        f", max {1e3 * max(calls):.3f}, {len(calls)} calls")
    return steps, window


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, spec: dict | None = None,
             config_overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> dict:
    """One run of cell `name`: the result line's fields but `device`.
    The overrides replace top-level keys of the configuration or the
    traffic (the CPU tests run small sizes with them)."""
    import torch

    spec = spec or load_spec()
    cell = workload(spec, name)
    config = {**load_data("configs", cell["config"]),
              **(config_overrides or {})}
    traffic = {**load_data("traffic", cell["traffic"]),
               **(traffic_overrides or {})}
    limits = load_data("limits", name)
    drv = driver(config)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    log(f"imports and card {time.perf_counter() - t_start:.3f} s")
    if trace:
        from hbench import spans

        handle = spans.begin()
    built = drv.build(config, traffic, device)
    log(f"built {time.perf_counter() - t_start:.3f} s (port's build "
        f"{built['build_s']:.3f} s)")
    run = drv.start(built, config, traffic, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if trace:
        setup_spans = spans.end(handle)
    log(f"set-up {setup_s:.3f} s")

    steps, window_s = timed_window(run, seconds, device)
    log(f"window {steps} steps in {window_s:.3f} s")
    rates = run.rates_of(steps, window_s)
    if trace:
        ctx = SimpleNamespace(build_s=built["build_s"],
                              steps_per_s=steps / window_s)
        ctx.flops_per_step, ctx.flops_dtype = run.flops_per_step()
        # the span stretch comes before any profiler capture: a capture
        # slows the rest of its process
        ctx.spans = spans.collect(
            run, device, setup_spans, capture_steps=0,
            steps=getattr(drv, "SPAN_STEPS", spans.STRETCH_STEPS))
        from hbench import trace as tr

        ctx.trace = tr.profile_steps(run.run_steps, drv.TRACE_STEPS)
        ctx.ops = tr.time_ops(run.ops())
        metrics = {}
        for m in reported(spec["per_layer"], name):
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": ctx.trace["busy_s"],
                 "window_s": ctx.trace["window_s"],
                 "power_limit": card_power(),
                 "ops": [{k: v for k, v in o.items()} for o in ctx.ops],
                 "trace_captures_busy_s": ctx.trace["captures_busy_s"]}
        breakdown = {"device_ops": ctx.trace["top_ops"],
                     "idle_gaps": ctx.trace["idle_gaps"]}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if not trace:
        values = {**rates, "setup_s": setup_s, "peak_mem_gib": peak / GIB}
        metrics = {}
        for m in reported(spec["end_to_end"], name):
            if m["name"] not in values:
                raise KeyError(f"cell {name} reports {m['name']}, which this "
                               "harness does not measure")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        extra, breakdown = {}, None

    run.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from hbench import check

    t0 = time.perf_counter()
    readings = drv.readings(run)
    log(f"check {time.perf_counter() - t0:.3f} s")
    checks = check.judge(readings, limits)
    correct = all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": steps, "failed": 0,
           "metrics": metrics, "memory_peak_bytes": peak, **extra,
           "readings": readings}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return out
